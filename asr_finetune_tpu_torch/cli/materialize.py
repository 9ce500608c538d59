"""Dataset materialization: HDF5 → parquet feature shards (PyTorch port).

`python -m asr_finetune_tpu_torch.cli.materialize --dataset_name in.h5
    --materialize_output out_dir [--n_mels 128] [--shard_size 256]
    [--num_procs N]`

Counterpart of asr_finetune_tpu/cli/materialize.py: the host float64
log-mel and the labels of every row, written as parquet shards that either
package reads (data/parquet.py) and that the parquet --data_mode values
train from. With --num_procs > 1 the rows are split into contiguous ranges,
one worker process each (started by spawn). Runs on the host only; needs
pyarrow. Prints {"files", "rows", "rows_per_sec"}.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time

from .. import config as config_lib
from ..data.hdf5 import Hdf5AudioReader
from ..data.parquet import materialize_hdf5_to_parquet, require_pyarrow
from ..models.tokenizer import load_tokenizer
from ..utils.logging_utils import setup_logging


def _worker(payload):
    (path, out_dir, n_mels, language, task, shard_size, start, end,
     model_path) = payload
    return materialize_hdf5_to_parquet(
        Hdf5AudioReader(path), load_tokenizer(model_path or None), out_dir,
        n_mels=n_mels, language=language, task=task, shard_size=shard_size,
        start=start, end=end)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--materialize_output", type=str, required=True)
    extra.add_argument("--n_mels", type=int, default=80)
    extra.add_argument("--shard_size", type=int, default=256)
    extra.add_argument("--num_procs", type=int, default=1)
    ens, rest = extra.parse_known_args(argv)
    args = config_lib.parse_args(rest)
    setup_logging()
    require_pyarrow()

    path = args.dataset_name if os.path.isabs(args.dataset_name) or \
        not args.path_to_data else os.path.join(args.path_to_data, args.dataset_name)
    reader = Hdf5AudioReader(path)
    n = len(reader)
    if args.limit_samples:
        n = min(n, args.limit_samples)

    t0 = time.time()
    if ens.num_procs <= 1:
        files = materialize_hdf5_to_parquet(
            reader, load_tokenizer(args.model_path or None), ens.materialize_output,
            n_mels=ens.n_mels, language=args.target_language, task=args.task,
            shard_size=ens.shard_size, limit=n)
    else:
        reader.close()
        bounds = [(i * n // ens.num_procs, (i + 1) * n // ens.num_procs)
                  for i in range(ens.num_procs)]
        payloads = [(path, ens.materialize_output, ens.n_mels, args.target_language,
                     args.task, ens.shard_size, s, e, args.model_path)
                    for s, e in bounds if e > s]
        with mp.get_context("spawn").Pool(len(payloads)) as pool:
            files = [f for fs in pool.map(_worker, payloads) for f in fs]
    dt = time.time() - t0
    out = {"files": len(files), "rows": n, "rows_per_sec": round(n / max(dt, 1e-9), 2)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

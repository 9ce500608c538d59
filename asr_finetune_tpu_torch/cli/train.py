"""Single-config training entry point (PyTorch port).

`python -m asr_finetune_tpu_torch.cli.train -c configs/xxx.config [flags]
    [--device cuda|cpu]`

Counterpart of asr_finetune_tpu/cli/train.py: one training run of one
configuration (run.run_trial), on one card unless --device cpu is given.
To re-train a previous HPO experiment's best trial, pass --from_best
<experiment storage dir>: the hyperparameter overrides are read from its
best_result.json.

Data-parallel over cards, one process each (parallel/mesh.py):
`torchrun --nproc_per_node N -m asr_finetune_tpu_torch.cli.train ...`, or
Slurm with COORDINATOR_ADDRESS; every rank prints the result.
"""
from __future__ import annotations

import json
import logging
import os
import sys

from .. import config as config_lib
from .. import run as run_lib
from ..parallel import mesh
from ..utils.logging_utils import setup_logging


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    hp = {}
    if "--from_best" in argv:
        i = argv.index("--from_best")
        exp_dir = argv[i + 1]
        del argv[i : i + 2]
        with open(os.path.join(exp_dir, "best_result.json")) as f:
            best = json.load(f)
        hp = best.get("hp") or {}
        print(f"re-training best trial {best.get('best_trial')} hp={hp}")
    args = config_lib.parse_args(argv)
    setup_logging(logging.DEBUG if args.debug else logging.INFO)
    with mesh.joined(args.device):
        result = run_lib.run_trial(args, hp=hp)
    print(json.dumps(result, default=str))
    return result


if __name__ == "__main__":
    main()

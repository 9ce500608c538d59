"""Offline evaluation entry point (PyTorch port).

`python -m asr_finetune_tpu_torch.cli.evaluate -c configs/xxx.config
    --checkpoint_dir <run>/checkpoints [--checkpoint_step N |
    --use_best_checkpoint] [--eval_output_dir out] [--test_dataset_name x.h5]
    [--generation_num_beams K] [--device cuda|cpu]`

Counterpart of asr_finetune_tpu/cli/evaluate.py: builds the model as
transcription does (--model_path or a random --model_type), restores a
training checkpoint of the port (cli.train's torch.save format: full
parameters, or with --peft the adapters and, under --adalora, the rank mask
applied to them), streams the HDF5 test set through the collator and runs
the OfflineEvaluator (evaluation/evaluate.py): resumable per-utterance
transcripts and corpus WER, greedy or beam search. Without --checkpoint_dir
it evaluates the model as built. Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

import torch

from .. import config as config_lib
from .. import run as run_lib
from ..data.collator import Collator, CollatorConfig
from ..data.hdf5 import Hdf5AudioReader
from ..evaluation.evaluate import EvalConfig, OfflineEvaluator
from ..training import lora as lora_lib
from ..training.checkpoint import CheckpointManager
from ..utils.logging_utils import setup_logging

logger = logging.getLogger(__name__)


def restore(args, ens, built: run_lib.BuiltModel):
    """(params, adapters) of the checkpoint ens names, restored into the
    built model's tensors; the best by eval_loss_wer (the trainer's metric)
    with --use_best_checkpoint."""
    params, adapters = built.params, built.adapters
    mgr = CheckpointManager(ens.checkpoint_dir, metric="eval_loss_wer",
                            adapter_only=args.peft)
    step = None
    if ens.checkpoint_step >= 0:
        step = ens.checkpoint_step
    elif ens.use_best_checkpoint:
        step = mgr.best_step()
    if adapters is None:
        step = mgr.restore_trees({"params": params}, step)
    else:
        trees = {"adapters": adapters}
        rank_mask = lora_lib.init_rank_mask(adapters) if args.adalora else None
        if rank_mask is not None:
            trees["rank_mask"] = rank_mask
        step = mgr.restore_trees(trees, step)
        if rank_mask is not None:
            with torch.no_grad():
                adapters = lora_lib.apply_rank_mask(adapters, rank_mask)
    logger.info("restored checkpoint step %d from %s", step, ens.checkpoint_dir)
    return params, adapters


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--checkpoint_dir", type=str, default="")
    extra.add_argument("--checkpoint_step", type=int, default=-1)
    extra.add_argument("--use_best_checkpoint", action="store_true")
    extra.add_argument("--eval_output_dir", type=str, default="./eval_out")
    extra.add_argument("--test_dataset_name", type=str, default="")
    ens, rest = extra.parse_known_args(argv)
    args = config_lib.parse_args(rest)
    setup_logging()

    built = run_lib.build_model(args)
    params, adapters = built.params, built.adapters
    if ens.checkpoint_dir:
        params, adapters = restore(args, ens, built)

    test_name = ens.test_dataset_name or args.dataset_name
    reader = Hdf5AudioReader(run_lib._resolve_path(args, test_name))
    collator = Collator(built.tokenizer, CollatorConfig(
        n_mels=built.cfg.num_mel_bins, language=args.target_language,
        task=args.task))

    B = args.per_device_eval_batch_size
    n = len(reader)
    if args.limit_samples:
        n = min(n, args.limit_samples)

    def batches():
        for i in range(0, n, B):
            rows = reader.read(list(range(i, min(i + B, n))))
            if rows:
                yield collator(rows)

    ecfg = EvalConfig(language=args.target_language, task=args.task,
                      max_length=args.generation_max_length,
                      num_beams=args.generation_num_beams,
                      length_penalty=args.length_penalty,
                      suppress_tokens=built.suppress_tokens,
                      begin_suppress_tokens=built.begin_suppress_tokens,
                      return_timestamps=args.return_timestamps,
                      decode_kv_int8=args.decode_kv_int8,
                      decode_w_int8=args.decode_w_int8,
                      batch_size=B, output_dir=ens.eval_output_dir,
                      compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    try:
        final = OfflineEvaluator(built.cfg, params, built.tokenizer, ecfg,
                                 adapters).run(batches())
    finally:
        reader.close()
    print(json.dumps({"wer": final["wer"],
                      "n_utterances": final["n_utterances"]}))
    return final


if __name__ == "__main__":
    main()

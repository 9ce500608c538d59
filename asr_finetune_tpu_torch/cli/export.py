"""Export a trained checkpoint for deployment (PyTorch port).

`python -m asr_finetune_tpu_torch.cli.export -c configs/xxx.config
    --checkpoint_dir <trial>/checkpoints --export_dir merged_model/
    [--checkpoint_step N] [--merge_adapters/--no-merge_adapters]
    [--adapter_path adapters.npz] [--device cuda|cpu]`

Counterpart of asr_finetune_tpu/cli/export.py: builds the model as the
training run did, restores one of its port checkpoints (full parameters,
or the adapters of an adapter-only PEFT checkpoint, with AdaLoRA's rank
mask applied to them; the best step by eval_loss_wer unless
--checkpoint_step names one, as cli.evaluate restores), folds the LoRA /
AdaLoRA deltas into the base (training/lora.merge_adapters: an int8 base
projection that takes a delta becomes fp32, the rest stays int8) and
writes the native npz format (models/native_io.save_params) that
--model_path reads in both packages: float leaves as fp32, int8 leaves as
int8. The port-only K-major int8 copies (`w_q8_nk`, made for the W8A8
kernel under --int8_matmul) are left out, so the npz holds the JAX tree's
leaves. With --adapter_path the masked adapter tree is also written as its
own npz.

When the checkpoint directory lies in an HPO trial's directory, the
trial's hp (its LoRA rank and alpha) are read from the trial's
trial_manifest.json, so the adapters are built at the trial's shapes.
Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

from .. import config as config_lib
from .. import run as run_lib
from ..models import native_io
from ..ops import quant as quant_lib
from ..training import lora as lora_lib
from ..training.checkpoint import load_trial_manifest
from ..training.optim import leaves
from ..utils.logging_utils import setup_logging
from .evaluate import restore

logger = logging.getLogger(__name__)


def _drop_k_major(tree):
    """The tree without the K-major int8 copies (a new tree)."""
    return {k: _drop_k_major(v) if isinstance(v, dict) else v
            for k, v in tree.items() if k != quant_lib.KMAJOR_KEY}


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--checkpoint_dir", type=str, required=True)
    extra.add_argument("--checkpoint_step", type=int, default=-1)
    extra.add_argument("--use_best_checkpoint", action="store_true", default=True)
    extra.add_argument("--export_dir", type=str, required=True,
                       help="output directory (native format: params.npz "
                            "+ config.json; load anywhere via --model_path)")
    extra.add_argument("--merge_adapters", action=argparse.BooleanOptionalAction,
                       default=True,
                       help="fold LoRA/AdaLoRA deltas into the base weights "
                            "(PEFT merge_and_unload equivalent)")
    extra.add_argument("--adapter_path", type=str, default="",
                       help="also write the raw adapter tree (npz)")
    ens, rest = extra.parse_known_args(argv)
    args = config_lib.parse_args(rest)
    setup_logging()

    manifest = load_trial_manifest(os.path.dirname(os.path.abspath(ens.checkpoint_dir)))
    hp = (manifest or {}).get("hp") or {}
    built = run_lib.build_model(args, train=True, hp=hp)
    params, adapters = restore(args, ens, built)

    if ens.adapter_path and adapters is not None:
        flat = native_io.params_to_numpy(adapters)
        np.savez(ens.adapter_path, **flat)
        logger.info("wrote adapters (%d arrays) to %s", len(flat), ens.adapter_path)

    if ens.merge_adapters and adapters is not None:
        params = lora_lib.merge_adapters(params, adapters)
        logger.info("merged adapter deltas into the base weights")

    params = _drop_k_major(params)
    native_io.save_params(ens.export_dir, params, built.cfg)
    n = sum(t.numel() for _, t in leaves(params))
    print(json.dumps({"export_dir": ens.export_dir, "params": n}))
    return 0


if __name__ == "__main__":
    main()

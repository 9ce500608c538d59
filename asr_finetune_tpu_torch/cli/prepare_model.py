"""Prepare a model directory for air-gapped training (PyTorch port).

`python -m asr_finetune_tpu_torch.cli.prepare_model --hf_dir <hf checkpoint dir>
    --output <native dir> [--verify] [--device cuda|cpu]`

Counterpart of asr_finetune_tpu/cli/prepare_model.py: converts an
already-downloaded HF Whisper checkpoint directory (config.json +
safetensors or pytorch_model.bin + vocab files) into the native format
(models/native_io.py, which both packages read through --model_path) with
models/convert_hf.load_pretrained, and copies the tokenizer's vocab files
beside it. `--verify` reloads the output onto --device, checks the leaf
count and runs one forward, whose logits must be finite. Runs on the card
unless --device cpu.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

from ..device import resolve_device
from ..models import whisper as W
from ..models.convert_hf import load_pretrained
from ..models.native_io import load_params, save_params
from ..training.optim import leaves
from ..utils.logging_utils import setup_logging

VOCAB_FILES = ("vocab.json", "merges.txt", "tokenizer.json", "normalizer.json",
               "added_tokens.json", "special_tokens_map.json")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--hf_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--verify", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="where --verify runs its forward: cuda (default) or cpu")
    a = p.parse_args(argv)
    setup_logging()
    device = resolve_device(a.device)

    params, cfg = load_pretrained(a.hf_dir, "cpu")
    save_params(a.output, params, cfg)
    copied = []
    for name in VOCAB_FILES:
        src = os.path.join(a.hf_dir, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(a.output, name))
            copied.append(name)

    if a.verify:
        params2, cfg2 = load_params(a.output, device)
        n1, n2 = len(leaves(params)), len(leaves(params2))
        if n1 != n2:
            raise AssertionError(f"{a.output}: {n2} leaves reloaded, {n1} written")
        mel = torch.zeros((1, 100, cfg2.num_mel_bins), device=device)
        toks = torch.zeros((1, 4), dtype=torch.long, device=device)
        with torch.no_grad():
            logits = W.forward(params2, mel, toks, cfg2, compute_dtype=torch.float32)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{a.output}: the forward's logits are not finite")
        print("verify OK")

    with np.load(os.path.join(a.output, "params.npz")) as z:
        n_leaves = len(z.files)
    print(json.dumps({"output": a.output, "leaves": n_leaves, "vocab_files": copied}))


if __name__ == "__main__":
    main()

"""Read and write the JAX package's native checkpoint (models/native_io.py:30-75).

Format: `params.npz` of flattened leaves keyed by "/"-joined tree paths
("encoder/layers/attn/q/w", stacked (L, d_in, d_out)), plus `config.json`
carrying the WhisperConfig under "whisper_config" and the format's name.
`save_params` writes exactly what the JAX `save_params` writes, so an
export of either package loads in the other.

`params_from_numpy` is the weight carry between the two packages: it turns
that flat dict into the port's parameters, a nested dict of tensors with the
JAX tree's keys and layouts, so every stacked (L, ...) weight keeps its
shape and a kernel can reach layer l by a pointer offset. Any tree of that
form carries: an int8 base ({"w_q8": int8, "w_scale": fp32} leaves stay
int8 and fp32) and an adapter tree (training/lora.py) alike.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .configs import WhisperConfig

PARAMS_FILE = "params.npz"
CONFIG_FILE = "config.json"
FORMAT = "asr_finetune_tpu.native_io.v1"

Params = Dict[str, Any]


def params_from_numpy(flat: Dict[str, np.ndarray], device,
                      dtype: torch.dtype = torch.float32) -> Params:
    """{"a/b/c": array} → nested {"a": {"b": {"c": tensor}}} on `device`;
    floating arrays become `dtype`, others (int8 weights, token ids) keep
    theirs."""
    tree: Params = {}
    for key, a in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        # a row-major copy: the source may be read-only, and HF's converted
        # weights are transposed views that the kernels refuse
        t = torch.from_numpy(np.array(a, order="C"))
        if t.is_floating_point():
            t = t.to(dtype)
        node[parts[-1]] = t.to(device)
    return tree


def params_to_numpy(params: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of params_from_numpy: nested tensors → flat {path: array},
    int8 as int8; a bf16 leaf as its fp32 values (numpy has no bf16)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(params_to_numpy(v, key))
        else:
            v = v.detach().cpu()
            out[key] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def save_params(path: str, params: Params, cfg: WhisperConfig) -> None:
    """params (a tree of tensors) as `path`/params.npz (params_to_numpy's
    leaves) and `path`/config.json."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, PARAMS_FILE), **params_to_numpy(params))
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump({"whisper_config": dataclasses.asdict(cfg), "format": FORMAT},
                  f, indent=2)


def load_params(path: str, device, dtype: torch.dtype = torch.float32
                ) -> Tuple[Params, WhisperConfig]:
    with open(os.path.join(path, CONFIG_FILE)) as f:
        meta = json.load(f)
    if "whisper_config" not in meta:
        raise ValueError(f"{path}: not a native checkpoint (no whisper_config)")
    cfg = WhisperConfig(**meta["whisper_config"])
    with np.load(os.path.join(path, PARAMS_FILE)) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_numpy(flat, device, dtype), cfg


def is_native_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, PARAMS_FILE))

"""int8 quantization of the frozen PEFT base and the W8A8 product (PyTorch port).

Counterpart of asr_finetune_tpu/ops/quant.py:
- `quantize_weight` / `dequantize_weight` / `quantize_tree_int8` (:49-81):
  symmetric per-output-channel int8 with an fp32 scale, stored as
  {"w_q8": int8 (L, d_in, d_out), "w_scale": fp32 (L, 1, d_out)} in place of
  each stacked q/k/v/o/fc1/fc2 weight; embeddings, the conv stem, layer
  norms, biases and the position tables stay in floating point;
- the W8A8 product (`_w8a8_impl` :221-332) with both outlier forms of
  bitsandbytes' LLM.int8(): the dynamic one (the k input features of
  largest |activation| over the batch go through a float side product
  against the dequantized weight rows and are masked out of the int8
  operand) and calibrated static sets per (d_in, d_out) class (an empty set
  is pure int8);
- `int8_matmul` (:335-371) as a torch.autograd.Function: the forward runs
  the W8A8 kernel (ops/w8a8_fused.py); the backward is the straight-through
  dx = dy @ W_deq^T with no gradient to the weight;
- `calibrate_int8_outliers` (:183-218).

The JAX module's process-wide flags (`set_int8_compute`,
`set_int8_outlier_cols`, `set_int8_outlier_static_idx` and the recording
buffer) are the fields of a `QuantConfig` the model carries: every
models/whisper.py function that meets an int8 weight takes it as an
argument. The outlier side products are small plain products (torch.matmul),
as they are XLA products in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .w8a8_fused import w8a8

Params = Dict[str, Any]

QUANT_KEY = "w_q8"
SCALE_KEY = "w_scale"
LINEAR_KEYS = ("q", "k", "v", "o", "fc1", "fc2")

Klass = Tuple[int, int]          # (d_in, d_out) of a product


@dataclasses.dataclass
class QuantConfig:
    """How the model computes a product with an int8 weight.

    matmul: W8A8 (--int8_matmul) instead of a product with the weight
      dequantized into the compute dtype.
    outlier_cols: k of the outlier decomposition (--int8_outlier_cols); 0 is
      the plain vector-wise product.
    static_idx: calibrated outlier columns per (d_in, d_out) class; a class
      missing here takes the dynamic top-k form (read only when k > 0).
    record: while calibrate_int8_outliers runs, the column amax seen per
      class."""
    matmul: bool = False
    outlier_cols: int = 0
    static_idx: Optional[Dict[Klass, Tuple[int, ...]]] = None
    record: Optional[Dict[Klass, np.ndarray]] = None


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., d_in, d_out) float → int8 values + per-output-channel scales."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return {QUANT_KEY: q.to(torch.int8), SCALE_KEY: scale}


def dequantize_weight(p: Params, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return p[QUANT_KEY].to(dtype) * p[SCALE_KEY].to(dtype)


def quantize_tree_int8(params: Params, min_ndim: int = 3) -> Params:
    """Every stacked linear weight {"w": (L, d_in, d_out)} under q/k/v/o/
    fc1/fc2 replaced by its int8 form (a new tree; the float weight is
    released as its int8 form replaces it, once the caller drops the old
    tree)."""
    def walk(node, parent=""):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
            elif k == "w" and parent in LINEAR_KEYS and v.dim() >= min_ndim:
                out.update(quantize_weight(v))
            else:
                out[k] = v
        return out
    return walk(params)


def _outlier_split(x: torch.Tensor, w_q8: torch.Tensor, w_scale: torch.Tensor,
                   cfg: QuantConfig):
    """(keep (K,) fp32 or None, addend (m, N) fp32 or None) of the outlier
    decomposition for x (m, K): the k columns routed through the float side
    product, by the calibrated set of this (d_in, d_out) class or, without
    one, by the largest column amax of x (the ranking reads x in its own
    dtype; only the order matters)."""
    k = cfg.outlier_cols
    d_in, d_out = x.shape[-1], w_q8.shape[-1]
    if k <= 0:
        return None, None
    static = None if cfg.static_idx is None else cfg.static_idx.get((d_in, d_out))
    if static is not None:
        idx = [i for i in static if i < d_in]
        if not idx:
            return None, None       # calibrated, no outliers: pure int8
        idx = torch.as_tensor(idx, dtype=torch.long, device=x.device)
    else:
        col_amax = x.abs().amax(dim=0).float()
        idx = torch.topk(col_amax, min(k, d_in)).indices
    x_outl = x[:, idx].float()                                 # (m, k), exact
    w_outl = w_q8[idx].float() * w_scale.reshape(1, -1).float()  # (k, N)
    keep = torch.ones((d_in,), dtype=torch.float32, device=x.device)
    keep[idx] = 0.0
    return keep, torch.matmul(x_outl, w_outl)


class Int8Matmul(torch.autograd.Function):
    """x (m, K) @ int8 W: the W8A8 forward, the straight-through backward
    (ops/quant.py `_int8_matmul_vjp`)."""

    @staticmethod
    def forward(ctx, x, w_q8, w_scale, cfg: QuantConfig):
        keep, addend = _outlier_split(x, w_q8, w_scale, cfg)
        ctx.save_for_backward(w_q8, w_scale)
        return w8a8(x.contiguous(), w_q8, w_scale, keep, addend)

    @staticmethod
    def backward(ctx, dy):
        w_q8, w_scale = ctx.saved_tensors
        w = w_q8.to(dy.dtype) * w_scale.reshape(1, -1).to(dy.dtype)
        return torch.matmul(dy, w.t()), None, None, None


def int8_matmul(x: torch.Tensor, w_q8: torch.Tensor, w_scale: torch.Tensor,
                cfg: QuantConfig) -> torch.Tensor:
    """x (..., d_in) @ (w_q8 (d_in, d_out) int8 · w_scale) as W8A8, in x's
    dtype. While calibrate_int8_outliers records, also keeps this product's
    column amax."""
    d_in, d_out = w_q8.shape
    x2 = x.reshape(-1, d_in)
    if cfg.record is not None:
        a = x2.detach().abs().amax(dim=0).float().cpu().numpy()
        cur = cfg.record.get((d_in, d_out))
        cfg.record[(d_in, d_out)] = a if cur is None else np.maximum(cur, a)
    y = Int8Matmul.apply(x2, w_q8, w_scale, cfg)
    return y.reshape(*x.shape[:-1], d_out)


def calibrate_int8_outliers(run_fn: Callable[[], Any], cfg: QuantConfig,
                            threshold: float = 6.0, max_cols: int = 16
                            ) -> Dict[Klass, Tuple[int, ...]]:
    """Run `run_fn()` (a forward over the int8 base) with the column amax of
    every W8A8 product recorded, then install in `cfg` as static outlier sets
    every input feature whose amax >= threshold (bitsandbytes' 6.0), largest
    first, at most max_cols per (d_in, d_out) class. Returns the map."""
    cfg.record = {}
    try:
        run_fn()
        idx_map = {}
        for klass, amax in cfg.record.items():
            cols = np.where(amax >= threshold)[0]
            if max_cols and cols.size > max_cols:
                cols = cols[np.argsort(amax[cols])[::-1][:max_cols]]
            idx_map[klass] = tuple(int(c) for c in np.sort(cols))
    finally:
        cfg.record = None
    cfg.static_idx = idx_map
    return idx_map

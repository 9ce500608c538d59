"""Fused per-token decoder kernels: CUDA (csrc/decoder_fused.cu) + plain versions.

Counterpart of asr_finetune_tpu/ops/decoder_fused.py. Each decoder layer of
a greedy decode step runs four wrappers, each replacing one Pallas kernel:

  fused_qkv   ← `fused_qkv` (:150; pl.pallas_call :195, `_qkv_kernel` :127)
  fused_attn  ← `fused_attn` (:310; pl.pallas_call :447, `_attn_kernel` :213),
                self mode (q given, keys at col > pos masked) and cross mode
                (q = (LN(x)@wq + bq)·hd^-0.5 computed inside, keys at
                col >= s_valid masked)
  fused_mlp   ← `fused_mlp` (:681; pl.pallas_call :738, `_mlp_kernel` :649)

Bound on the card: bytes. A call streams one layer's weights (and K/V rows)
once per group of up to 8 rows, a few flops per byte; the kernels are
split-K GEMVs and a split-T attention built to stream. The CUDA source says how.

Wrappers take unstacked per-layer weights (tests) or the full stacked
(L, ...) tensors plus `layer_idx` (the decode loop); the kernels read layer
l through a pointer offset, never through a copied slice. For CUDA tensors
a wrapper launches its kernel(s) or raises; CPU tensors take the plain
PyTorch version beside it. One wrapper call may launch more than one CUDA
kernel (fused_attn: the cross q projection, attention partials, their
combine, the wo projection), and counts once in LAUNCHES.

Pending (raise NotImplementedError): the int8 options of the Pallas kernels
(k_scale/v_scale int8 KV, w*_scale int8 weights), kv_group > 1 (shared
beam cross-KV) and fused_attn_beam.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

HEAD_DIM = 64     # every released Whisper variant uses 64-dim heads
CHUNK = 256       # keys per attention block (csrc CHUNK)
_NB = 16          # output columns per GEMV block (csrc NB)

# wrapper launches on the card, by kernel name (chip_smoke.py reads them)
LAUNCHES = {"fused_qkv": 0, "fused_attn_self": 0, "fused_attn_cross": 0,
            "fused_mlp": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pending(what: str, **opts) -> None:
    set_opts = [k for k, v in opts.items() if v is not None]
    if set_opts:
        raise NotImplementedError(
            f"{what}: {', '.join(set_opts)} (the int8 options of the Pallas "
            "kernel) are not ported yet")


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference chip_smoke.py holds the
# kernels against)
# ---------------------------------------------------------------------------

def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    """fp32 layer norm over the last axis (models/whisper.layer_norm)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (already in the activation dtype, as fp32) @ w cast to that dtype,
    fp32 accumulation: jnp.dot(h, w, preferred_element_type=f32)."""
    return torch.matmul(h, w.float())


def fused_qkv_plain(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, kv_dtype=None):
    """One layer: x (B, d) → q (B, d) fp32 pre-scaled by hd^-0.5, k, v."""
    kv_dtype = kv_dtype or x.dtype
    h = _ln(x, ln_scale, ln_bias).to(x.dtype).float()
    q = (_proj(h, wq.to(x.dtype)) + bq.float()) * HEAD_DIM ** -0.5
    k = _proj(h, wk.to(x.dtype)).to(kv_dtype)
    v = (_proj(h, wv.to(x.dtype)) + bv.float()).to(kv_dtype)
    return q, k, v


def _cross_q(x, ln_scale, ln_bias, wq, bq):
    h = _ln(x, ln_scale, ln_bias).to(x.dtype).float()
    return (_proj(h, wq.to(x.dtype)) + bq.float()) * HEAD_DIM ** -0.5


def fused_attn_plain(x, k, v, wo, bo, q=None, n_valid=None, ln_scale=None,
                     ln_bias=None, wq=None, bq=None):
    """One layer: single-query attention of x's rows over k/v (B, T, d)
    restricted to keys t < n_valid, then o @ wo + bo + x."""
    if q is None:
        q = _cross_q(x, ln_scale, ln_bias, wq, bq)
    B, _, d = k.shape
    H = d // HEAD_DIM
    kh = k[:, :n_valid].float().reshape(B, n_valid, H, HEAD_DIM)
    vh = v[:, :n_valid].float().reshape(B, n_valid, H, HEAD_DIM)
    qh = q.to(k.dtype).float().reshape(B, H, HEAD_DIM)
    s = torch.einsum("bhd,bthd->bht", qh, kh)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bht,bthd->bhd", e.to(v.dtype).float(), vh)
    o = (pv / l).reshape(B, d).to(x.dtype).float()
    out = _proj(o, wo.to(x.dtype)) + bo.float() + x.float()
    return out.to(x.dtype)


def fused_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """One layer: x (B, d) → gelu(LN(x) @ w1 + b1) @ w2 + b2 + x."""
    h = _ln(x, ln_scale, ln_bias).to(x.dtype).float()
    g = torch.nn.functional.gelu(_proj(h, w1.to(x.dtype)) + b1.float())  # exact erf
    out = _proj(g.to(x.dtype).float(), w2.to(x.dtype)) + b2.float() + x.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _at(a: Optional[torch.Tensor], layer_idx, ndim: int):
    """Layer `layer_idx` of a stacked operand (a view), or `a` itself when
    unstacked (`ndim` = the per-layer rank)."""
    if a is None or layer_idx is None or a.dim() == ndim:
        return a
    return a[layer_idx]


def _ptr(a: torch.Tensor, ndim: int, dtype, shape, *, layer_idx,
         device: torch.device) -> int:
    """Device address of layer `layer_idx` of `a` (or of `a` if unstacked),
    after checking device, dtype, per-layer shape, contiguity and the layer
    index."""
    if a.device != device:
        raise ValueError(f"operand on {a.device}, expected {device}")
    if a.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    if a.dim() == ndim:
        per, off = tuple(a.shape), 0
    elif a.dim() == ndim + 1 and layer_idx is not None:
        if not 0 <= layer_idx < a.shape[0]:
            raise IndexError(f"layer_idx {layer_idx} outside [0, {a.shape[0]})")
        per, off = tuple(a.shape[1:]), layer_idx * a.stride(0) * a.element_size()
    else:
        raise ValueError(f"operand of rank {a.dim()} for a rank-{ndim} "
                         f"layer (layer_idx={layer_idx})")
    if per != tuple(shape):
        raise ValueError(f"expected per-layer shape {tuple(shape)}, got {per}")
    return a.data_ptr() + off


def _check_x(x: torch.Tensor, what: str) -> Tuple[int, int]:
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (B, d) tensor")
    B, d = x.shape
    if B < 1:
        raise ValueError(f"{what}: no rows")
    if d % HEAD_DIM or x.data_ptr() % 16:
        raise ValueError(f"{what}: d={d} must be a multiple of {HEAD_DIM} "
                         "and x 16-byte aligned")
    _build.dtype_code(x)
    return B, d


def fused_qkv(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
              wq: torch.Tensor, bq: torch.Tensor, wk: torch.Tensor,
              wv: torch.Tensor, bv: torch.Tensor,
              wq_scale=None, wk_scale=None, wv_scale=None,
              kv_dtype=None, layer_idx=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, d) → (q (B, d) fp32 pre-scaled by hd^-0.5, k (B, d), v (B, d)).

    With layer_idx the weights come stacked ((L, d, d), biases (L, d)) and
    the kernel reads layer layer_idx in place."""
    _pending("fused_qkv", wq_scale=wq_scale, wk_scale=wk_scale,
             wv_scale=wv_scale)
    if x.device.type == "cpu":
        return fused_qkv_plain(
            x, _at(ln_scale, layer_idx, 1), _at(ln_bias, layer_idx, 1),
            _at(wq, layer_idx, 2), _at(bq, layer_idx, 1),
            _at(wk, layer_idx, 2), _at(wv, layer_idx, 2),
            _at(bv, layer_idx, 1), kv_dtype)
    return _fused_qkv_cuda(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, kv_dtype,
                           layer_idx)


def _fused_qkv_cuda(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, kv_dtype,
                    layer_idx):
    B, d = _check_x(x, "fused_qkv")
    if (kv_dtype or x.dtype) != x.dtype:
        raise TypeError("the CUDA fused_qkv writes k/v in x's dtype")
    T, f32 = x.dtype, torch.float32
    ptr = functools.partial(_ptr, layer_idx=layer_idx, device=x.device)
    q = torch.empty((B, d), dtype=f32, device=x.device)
    k = torch.empty_like(x)
    v = torch.empty_like(x)
    lib = _lib()
    err = lib.fused_qkv_fwd(
        _build.dtype_code(x), x.data_ptr(),
        ptr(ln_scale, 1, f32, (d,)),
        ptr(ln_bias, 1, f32, (d,)),
        ptr(wq, 2, T, (d, d)), ptr(bq, 1, T, (d,)),
        ptr(wk, 2, T, (d, d)), ptr(wv, 2, T, (d, d)),
        ptr(bv, 1, T, (d,)),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), B, d, _build.stream_ptr(x))
    _build.check(lib, err, "fused_qkv")
    LAUNCHES["fused_qkv"] += 1
    return q, k, v


def fused_attn(x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               wo: torch.Tensor, bo: torch.Tensor,
               q: Optional[torch.Tensor] = None, pos=None,
               s_valid: Optional[int] = None,
               ln_scale=None, ln_bias=None, wq=None, bq=None,
               k_scale=None, v_scale=None, wq_scale=None, wo_scale=None,
               layer_idx=None, kv_group: int = 1) -> torch.Tensor:
    """Single-query attention over a dense KV cache + output proj + residual.

    x (B, d) residual input; k/v (B, T, d), or stacked (L, B, T, d) with
    layer_idx. Self-attention: pass q (B, d) fp32 from fused_qkv and pos —
    keys at col > pos are masked. Cross-attention: pass ln_scale/ln_bias/
    wq/bq instead (q computed inside) and s_valid = the real source length
    (the padded tail beyond it is masked)."""
    _pending("fused_attn", k_scale=k_scale, v_scale=v_scale,
             wq_scale=wq_scale, wo_scale=wo_scale)
    if kv_group != 1:
        raise NotImplementedError("fused_attn: kv_group > 1 (shared beam "
                                  "cross-KV) is not ported yet")
    self_mode = q is not None
    if self_mode == (s_valid is not None) or (pos is None) == self_mode:
        raise ValueError("fused_attn: pass q and pos (self) or s_valid and "
                         "the ln/wq/bq operands (cross)")
    n_valid = int(pos) + 1 if self_mode else int(s_valid)
    if x.device.type == "cpu":
        return fused_attn_plain(
            x, _at(k, layer_idx, 3), _at(v, layer_idx, 3),
            _at(wo, layer_idx, 2), _at(bo, layer_idx, 1), q=q,
            n_valid=n_valid, ln_scale=_at(ln_scale, layer_idx, 1),
            ln_bias=_at(ln_bias, layer_idx, 1), wq=_at(wq, layer_idx, 2),
            bq=_at(bq, layer_idx, 1))
    return _fused_attn_cuda(x, k, v, wo, bo, q, n_valid, ln_scale, ln_bias,
                            wq, bq, layer_idx)


def _fused_attn_cuda(x, k, v, wo, bo, q, n_valid, ln_scale, ln_bias, wq, bq,
                     layer_idx):
    self_mode = q is not None
    B, d = _check_x(x, "fused_attn")
    T, f32 = x.dtype, torch.float32
    ptr = functools.partial(_ptr, layer_idx=layer_idx, device=x.device)
    T_len = k.shape[-2]
    if not 1 <= n_valid <= T_len:
        raise ValueError(f"fused_attn: {n_valid} valid keys for a cache of {T_len}")
    n_split = -(-T_len // CHUNK)
    part = torch.empty((B, d // HEAD_DIM, n_split, HEAD_DIM + 2), dtype=f32,
                       device=x.device)
    o_buf = torch.empty_like(x)        # the attention output, before @wo
    out = torch.empty_like(x)
    if self_mode:
        if q.shape != (B, d) or q.dtype != f32 or not q.is_contiguous():
            raise ValueError("fused_attn: q must be a contiguous (B, d) fp32 tensor")
        q_ptr, ln_s, ln_b, wq_p, bq_p, q_buf = q.data_ptr(), None, None, None, None, None
    else:
        q_buf = torch.empty((B, d), dtype=f32, device=x.device)
        q_ptr = None
        ln_s = ptr(ln_scale, 1, f32, (d,))
        ln_b = ptr(ln_bias, 1, f32, (d,))
        wq_p = ptr(wq, 2, T, (d, d))
        bq_p = ptr(bq, 1, T, (d,))
    lib = _lib()
    err = lib.fused_attn_fwd(
        _build.dtype_code(x), x.data_ptr(), q_ptr, ln_s, ln_b, wq_p, bq_p,
        ptr(k, 3, T, (B, T_len, d)),
        ptr(v, 3, T, (B, T_len, d)),
        ptr(wo, 2, T, (d, d)), ptr(bo, 1, T, (d,)),
        None if q_buf is None else q_buf.data_ptr(), part.data_ptr(),
        o_buf.data_ptr(), out.data_ptr(), B, T_len, d, n_valid,
        _build.stream_ptr(x))
    _build.check(lib, err, "fused_attn")
    LAUNCHES["fused_attn_self" if self_mode else "fused_attn_cross"] += 1
    return out


def fused_mlp(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, w1_scale=None, w2_scale=None,
              layer_idx=None) -> torch.Tensor:
    """x (B, d) → ln → fc1 (d, ff) → exact GELU → fc2 (ff, d) → + x. With
    layer_idx the weights come stacked ((L, d, ff) etc.)."""
    _pending("fused_mlp", w1_scale=w1_scale, w2_scale=w2_scale)
    if x.device.type == "cpu":
        return fused_mlp_plain(
            x, _at(ln_scale, layer_idx, 1), _at(ln_bias, layer_idx, 1),
            _at(w1, layer_idx, 2), _at(b1, layer_idx, 1),
            _at(w2, layer_idx, 2), _at(b2, layer_idx, 1))
    return _fused_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, layer_idx)


def _fused_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, layer_idx):
    B, d = _check_x(x, "fused_mlp")
    T, f32 = x.dtype, torch.float32
    ptr = functools.partial(_ptr, layer_idx=layer_idx, device=x.device)
    ff = w1.shape[-1]
    if ff % _NB:
        raise ValueError(f"fused_mlp: ff={ff} is not a multiple of {_NB}")
    g = torch.empty((B, ff), dtype=T, device=x.device)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.fused_mlp_fwd(
        _build.dtype_code(x), x.data_ptr(),
        ptr(ln_scale, 1, f32, (d,)),
        ptr(ln_bias, 1, f32, (d,)),
        ptr(w1, 2, T, (d, ff)), ptr(b1, 1, T, (ff,)),
        ptr(w2, 2, T, (ff, d)), ptr(b2, 1, T, (d,)),
        g.data_ptr(), out.data_ptr(), B, d, ff, _build.stream_ptr(x))
    _build.check(lib, err, "fused_mlp")
    LAUNCHES["fused_mlp"] += 1
    return out


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("decoder_fused")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_qkv_fwd.argtypes = [I] + [P] * 11 + [I, I, P]
        lib.fused_attn_fwd.argtypes = [I] + [P] * 14 + [I, I, I, I, P]
        lib.fused_mlp_fwd.argtypes = [I] + [P] * 9 + [I, I, I, P]
        for fn in (lib.fused_qkv_fwd, lib.fused_attn_fwd, lib.fused_mlp_fwd):
            fn.restype = I
        _LIB = lib
    return _LIB

"""Encoder self-attention: CUDA kernel (csrc/encoder_attention.cu) + plain version.

Counterpart of asr_finetune_tpu/ops/encoder_attention.py, forward only.
The TPU kernel replaced here is `_fwd_packed` (:286, pl.pallas_call :294,
kernel `_fwd_kernel_packed` :206), reached through `encoder_attention`
(:356): non-causal softmax attention straight on packed (B, T, H*hd) q/k/v,
keys at col >= s_valid masked, fp32 softmax and accumulation, scale
hd^-0.5, p cast to the input dtype for the p@v product, the division by the
row sum deferred past it.

Bound on the card: operations (46 GFLOP against 61 MB per large-v3 layer at
B=4). The TPU kernel keeps a whole 1500-row fp32 tile in VMEM; the CUDA
kernel is an online-softmax loop over 64-key tiles in shared memory, one
block per (64-query tile, head, batch), reading q/k/v by strides from the
packed layout and masking the ragged edge and s_valid itself. See the
source for the design. The TPU's head grouping (`_group_packed`) and row
padding are not ported: the kernel takes any T and any head count.

The wrapper runs the kernel for CUDA tensors and the plain PyTorch version
(`dense_attention_packed_plain`) for CPU tensors; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG = -1e30  # finite -inf keeps masked rows NaN-free
HEAD_DIM = 64

# wrapper launches on the card, by kernel name (chip_smoke.py reads them)
LAUNCHES = {"encoder_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def dense_attention_packed_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, hd: int,
                                 s_valid: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, (B, Tq, H*hd) → (B, Tq, H*hd):
    scores and softmax in fp32, p cast to v's dtype for p@v, division
    deferred, output in q's dtype (`_fwd_kernel_packed`'s arithmetic)."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = D // hd
    qh = q.reshape(B, Tq, H, hd).transpose(1, 2).float()
    kh = k.reshape(B, Tk, H, hd).transpose(1, 2).float()
    vh = v.reshape(B, Tk, H, hd).transpose(1, 2).float()
    s = torch.matmul(qh, kh.transpose(-1, -2)) * hd ** -0.5
    if s_valid < Tk:
        s[..., s_valid:] = NEG
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    ev = torch.matmul(e.to(v.dtype).float(), vh)
    out = (ev * r).to(q.dtype)                                # (B, H, Tq, hd)
    return out.transpose(1, 2).reshape(B, Tq, D)


def _strides(t: torch.Tensor):
    if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8 \
            or t.data_ptr() % 16:
        raise ValueError("encoder attention kernel needs a unit head-dim "
                         "stride, time/batch strides that are multiples of 8 "
                         f"and a 16-byte aligned base; got strides {t.stride()}")
    return t.stride(0), t.stride(1)


def dense_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           hd: int, s_valid: int) -> torch.Tensor:
    """Attention over packed (B, T, H*hd) q/k/v, keys masked at col >=
    s_valid. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return dense_attention_packed_plain(q, k, v, hd, s_valid)
    return _dense_attention_packed_cuda(q, k, v, hd, s_valid)


def _dense_attention_packed_cuda(q, k, v, hd: int, s_valid: int) -> torch.Tensor:
    if hd != HEAD_DIM:
        raise ValueError(f"encoder attention kernel needs {HEAD_DIM}-dim "
                         f"heads, got {hd}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must lie on one device")
    B, Tq, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, D) or v.shape != k.shape or D % hd:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not 1 <= s_valid <= Tk:
        raise ValueError(f"s_valid {s_valid} outside [1, {Tk}]")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _lib()
    err = lib.encoder_attention_fwd(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, D // hd, Tq, Tk, s_valid,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        _build.stream_ptr(q))
    _build.check(lib, err, "encoder_attention")
    LAUNCHES["encoder_attention"] += 1
    return out


def encoder_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """(B, Tq, H, hd) non-causal unmasked attention (the JAX function of the
    same name): a free reshape to the packed layout, then the kernel."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    out = dense_attention_packed(q.reshape(B, Tq, H * hd),
                                 k.reshape(B, Tk, H * hd),
                                 v.reshape(B, Tk, H * hd), hd, Tk)
    return out.reshape(B, Tq, H, hd)


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("encoder_attention")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.encoder_attention_fwd.argtypes = [I, P, P, P, P, I, I, I, I, I,
                                              L, L, L, L, L, L, L, L, P]
        lib.encoder_attention_fwd.restype = I
        _LIB = lib
    return _LIB

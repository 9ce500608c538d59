"""Encoder self/cross attention: CUDA kernels (csrc/encoder_attention.cu) + plain versions.

Counterpart of asr_finetune_tpu/ops/encoder_attention.py, packed layout.
Two TPU kernels are replaced here:

- forward: `_fwd_packed` (:286, pl.pallas_call :294, kernel
  `_fwd_kernel_packed` :206), reached through `encoder_attention` (:356):
  non-causal softmax attention straight on packed (B, T, H*hd) q/k/v, keys
  at col >= s_valid masked, fp32 softmax and accumulation, scale hd^-0.5, p
  cast to the input dtype for the p@v product, the division by the row sum
  deferred past it.
- backward: `_bwd_packed` (:311, pl.pallas_call :320, kernel
  `_bwd_kernel_packed` :225): dq, dk, dv from (q, k, v, do) with p
  recomputed, di = rowsum(p * dp) from unrounded fp32 p, ds rounded to the
  input dtype, p rounded for the p^T @ do product.

Bound on the card: operations for the encoder (46 GFLOP forward, 115 GFLOP
backward against 61 / 108 MB per large-v3 layer at B=4), bytes for the
teacher-forced cross-attention at short label buckets. The TPU kernels keep
a whole 1500-row fp32 tile in VMEM; the CUDA forward is an online-softmax
loop over 64-key tiles that also saves each row's logsumexp, and the
backward recomputes p tile by tile from it in two deterministic kernels
(dq with di, then dk/dv). See the source for the design. The TPU's head
grouping (`_group_packed`) and row padding are not ported: the kernels take
any T and any head count.

`dense_attention_packed` is differentiable: when autograd needs its
gradient it runs as `DenseAttentionPacked`, whose backward is the backward
kernel. CUDA tensors launch the kernels or raise; CPU tensors take the plain
versions (`dense_attention_packed_plain`, `dense_attention_packed_bwd_plain`);
nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG = -1e30  # finite -inf keeps masked rows NaN-free
HEAD_DIM = 64

# wrapper launches on the card, by kernel name (chip_smoke.py reads them)
LAUNCHES = {"encoder_attention": 0, "encoder_attention_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, T, H*hd) → (B, H, T, hd) in fp32."""
    B, T, D = x.shape
    return x.reshape(B, T, D // hd, hd).transpose(1, 2).float()


def _merge(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, T, hd) → (B, T, H*hd) in dtype."""
    B, H, T, hd = x.shape
    return x.to(dtype).transpose(1, 2).reshape(B, T, H * hd)


def _scores(qh: torch.Tensor, kh: torch.Tensor, hd: int, s_valid: int):
    """Scaled scores (B, H, Tq, Tk) in fp32, keys at col >= s_valid masked."""
    s = torch.matmul(qh, kh.transpose(-1, -2)) * hd ** -0.5
    if s_valid < kh.shape[2]:
        s[..., s_valid:] = NEG
    return s


def _probs(qh: torch.Tensor, kh: torch.Tensor, hd: int, s_valid: int):
    """Masked scaled scores → (unnormalised e, row sums), fp32."""
    s = _scores(qh, kh, hd, s_valid)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e, e.sum(dim=-1, keepdim=True)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, hd: int,
                        s_valid: int) -> torch.Tensor:
    """Plain version of the forward kernel's lse output: the (B, H, Tq) fp32
    logsumexp of each row's masked scaled scores."""
    return torch.logsumexp(_scores(_heads(q, hd), _heads(k, hd), hd, s_valid),
                           dim=-1)


def dense_attention_packed_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, hd: int,
                                 s_valid: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, (B, Tq, H*hd) →
    (B, Tq, H*hd): scores and softmax in fp32, p cast to v's dtype for p@v,
    division deferred, output in q's dtype (`_fwd_kernel_packed`)."""
    e, l = _probs(_heads(q, hd), _heads(k, hd), hd, s_valid)
    ev = torch.matmul(e.to(v.dtype).float(), _heads(v, hd))
    return _merge(ev * (1.0 / l), q.dtype)


def dense_attention_packed_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, do: torch.Tensor,
                                     hd: int, s_valid: int):
    """Plain PyTorch version of the backward kernel, the arithmetic of
    `_bwd_kernel_packed` step by step: p = softmax(scale q k^T) in fp32,
    dp = do v^T, di = rowsum(p * dp), ds = p * (dp - di) rounded to q's
    dtype, dq = scale ds k, dk = scale ds^T q, dv = p^T do with p rounded to
    do's dtype; fp32 products, outputs in the inputs' dtypes."""
    qh, kh, vh, doh = (_heads(x, hd) for x in (q, k, v, do))
    e, l = _probs(qh, kh, hd, s_valid)
    p = e / l
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    di = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - di)).to(q.dtype).float()
    scale = hd ** -0.5
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), doh)
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


def _strides(t: torch.Tensor):
    if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8 \
            or t.data_ptr() % 16:
        raise ValueError("encoder attention kernel needs a unit head-dim "
                         "stride, time/batch strides that are multiples of 8 "
                         f"and a 16-byte aligned base; got strides {t.stride()}")
    return t.stride(0), t.stride(1)


def _check(q, k, v, hd: int, s_valid: int, *others):
    if hd != HEAD_DIM:
        raise ValueError(f"encoder attention kernel needs {HEAD_DIM}-dim "
                         f"heads, got {hd}")
    ts = (q, k, v) + others
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"operand dtypes differ: {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("operands must lie on one device")
    B, Tq, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, D) or v.shape != k.shape or D % hd \
            or any(t.shape != q.shape for t in others):
        raise ValueError(f"bad shapes {[tuple(t.shape) for t in ts]}")
    if not 1 <= s_valid <= Tk:
        raise ValueError(f"s_valid {s_valid} outside [1, {Tk}]")
    return B, Tq, Tk, D // hd


def _dense_attention_packed_cuda(q, k, v, hd: int, s_valid: int,
                                 with_lse: bool = False):
    """The forward kernel: out, and with with_lse the (B, H, Tq) fp32
    logsumexp of the rows (else None)."""
    B, Tq, Tk, H = _check(q, k, v, hd, s_valid)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    err = lib.encoder_attention_fwd(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), B, H, Tq,
        Tk, s_valid, *_strides(q), *_strides(k), *_strides(v),
        *_strides(out), _build.stream_ptr(q))
    _build.check(lib, err, "encoder_attention")
    LAUNCHES["encoder_attention"] += 1
    return out, lse


def _dense_attention_packed_bwd_cuda(q, k, v, do, lse, hd: int, s_valid: int):
    """The backward kernels: (dq, dk, dv) from the forward's operands, its
    logsumexp and the output gradient."""
    B, Tq, Tk, H = _check(q, k, v, hd, s_valid, do)
    if lse.dtype != torch.float32 or lse.shape != (B, H, Tq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous fp32 (B, H, Tq) tensor on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    di = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.encoder_attention_bwd(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, Tq, Tk, s_valid,
        *_strides(q), *_strides(k), *_strides(v), *_strides(do),
        *_strides(dq), *_strides(dk), *_strides(dv), _build.stream_ptr(q))
    _build.check(lib, err, "encoder_attention_bwd")
    LAUNCHES["encoder_attention_bwd"] += 1
    return dq, dk, dv


class DenseAttentionPacked(torch.autograd.Function):
    """Differentiable packed attention (the JAX `dense_attention_packed`
    custom_vjp): on CUDA tensors the forward kernel saves its logsumexp and
    the backward kernel computes (dq, dk, dv) from it; on CPU tensors the
    plain versions run."""

    @staticmethod
    def forward(ctx, q, k, v, hd: int, s_valid: int):
        if q.device.type == "cpu":
            out, lse = dense_attention_packed_plain(q, k, v, hd, s_valid), None
        else:
            out, lse = _dense_attention_packed_cuda(q, k, v, hd, s_valid,
                                                    with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.hd, ctx.s_valid = hd, s_valid
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            grads = dense_attention_packed_bwd_plain(q, k, v, do, ctx.hd,
                                                     ctx.s_valid)
        else:
            grads = _dense_attention_packed_bwd_cuda(q, k, v, do, lse, ctx.hd,
                                                     ctx.s_valid)
        return (*grads, None, None)


def dense_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           hd: int, s_valid: int) -> torch.Tensor:
    """Attention over packed (B, T, H*hd) q/k/v, keys masked at col >=
    s_valid. CUDA tensors launch the kernel; CPU tensors take the plain
    version. Differentiable through DenseAttentionPacked when autograd
    needs it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return DenseAttentionPacked.apply(q, k, v, hd, s_valid)
    if q.device.type == "cpu":
        return dense_attention_packed_plain(q, k, v, hd, s_valid)
    return _dense_attention_packed_cuda(q, k, v, hd, s_valid)[0]


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
        lib.encoder_attention_fwd.argtypes = [I, P, P, P, P, P, I, I, I, I, I,
                                              L, L, L, L, L, L, L, L, P]
        lib.encoder_attention_fwd.restype = I
        lib.encoder_attention_bwd.argtypes = [I, P, P, P, P, P, P, P, P, P,
                                              I, I, I, I, I] + [L] * 14 + [P]
        lib.encoder_attention_bwd.restype = I
        _LIB = lib
    return _LIB

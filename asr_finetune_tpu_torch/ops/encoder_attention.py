"""Encoder self/cross attention: CUDA kernels (csrc/encoder_attention.cu) + plain versions.

Counterpart of asr_finetune_tpu/ops/encoder_attention.py. Six TPU functions
are replaced here, all by the two kernels of the CUDA source launched on
other strides (the TPU functions run one kernel body under other block
maps):

- forward, packed layout: `_fwd_packed` (:286, pl.pallas_call :294, kernel
  `_fwd_kernel_packed` :206), reached through `encoder_attention` (:356):
  non-causal softmax attention straight on packed (B, T, H*hd) q/k/v, keys
  at col >= s_valid masked, fp32 softmax and accumulation, scale hd^-0.5, p
  cast to the input dtype for the p@v product, the division by the row sum
  deferred past it.
- backward, packed layout: `_bwd_packed` (:311, pl.pallas_call :320, kernel
  `_bwd_kernel_packed` :225): dq, dk, dv from (q, k, v, do) with p
  recomputed, di = rowsum(p * dp) from unrounded fp32 p, ds rounded to the
  input dtype, p rounded for the p^T @ do product.
- the (BH, T, hd) layout: `_fwd` (:133, call :140, kernel `_fwd_kernel` :57)
  and `_bwd` (:156, call :166, kernel `_bwd_kernel` :77), the same
  arithmetic per (batch·head): `dense_attention` launches the packed kernels
  with B' = BH, H = 1 and time stride hd. `encoder_attention` reaches it
  under ASR_TPU_DENSE_PACKED=0, with rows padded to a multiple of 128.
- the fused-qkv layout: `_fwd_qkv` (:457, call :466, kernel :206) and
  `_bwd_qkv` (:484, call :494, kernel :225): q, k and v are the column
  blocks [0, D), [D, 2D), [2D, 3D) of one (B, T, 3D) buffer (time stride
  3D), every row valid. `dense_attention_qkv` hands the kernels the three
  column views (no copies), and its backward writes dq, dk and dv through
  the strides of the three views of one (B, T, 3D) gradient buffer: the
  layout of the JAX VJP, with no concatenate.

Bound on the card: operations for the encoder (46 GFLOP forward, 115 GFLOP
backward against 61 / 108 MB per large-v3 layer at B=4), bytes for the
teacher-forced cross-attention at short label buckets. The TPU kernels keep
a whole 1500-row fp32 tile in VMEM; the CUDA forward is an online-softmax
loop over 64-key tiles (in bf16 on wgmma and TMA, 128 or 64 queries a
block, the output stored by TMA) that also saves each row's logsumexp, and
the backward recomputes p tile by tile from it: in bf16 a di pass, a key-major
dk/dv pass on wgmma and TMA that adds dq into an fp32 accumulator with TMA
reduce-adds (so dq's last fp32 bits vary from run to run), and a pass that
rounds dq; in fp32 two deterministic kernels (dq with di, then dk/dv).
See the source for the design. The TPU's head
grouping (`_group_packed`), its 48 MB VMEM bound and its tile tables are
not ported: the kernels take any T and any head count.

Each layout is differentiable through its autograd Function
(`DenseAttentionPacked`, `DenseAttention`, `DenseAttentionQKV`), whose
backward is the backward kernel. CUDA tensors launch the kernels or raise;
CPU tensors take the plain versions (`dense_attention_packed_plain`,
`dense_attention_packed_bwd_plain`, reused through views by the other two
layouts); nothing falls back. Launches are counted per layout in LAUNCHES.
"""
from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from . import _build

NEG = -1e30  # finite -inf keeps masked rows NaN-free
HEAD_DIM = 64

# the layouts' launch counters: the forward under its name, the backward
# under name + "_bwd"
PACKED, BH, QKV = "encoder_attention", "encoder_attention_bh", "encoder_attention_qkv"
# wrapper launches on the card, by kernel and layout (chip_smoke.py reads them)
LAUNCHES = {n + sfx: 0 for n in (PACKED, BH, QKV) for sfx in ("", "_bwd")}


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
                                 with_lse: bool = False, name: str = PACKED):
    """The forward kernel: out, and with with_lse the (B, H, Tq) fp32
    logsumexp of the rows (else None). q/k/v may be strided views (the
    fused-qkv layout's column blocks); out is a new contiguous tensor. In
    bf16 the kernel reads q/k/v and writes out by TMA: every batch and time
    stride a multiple of 8 elements and every base 16-byte aligned
    (`_strides` raises otherwise). `name`: the layout whose counter the
    launch adds to."""
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
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return out, lse


def _dense_attention_packed_bwd_cuda(q, k, v, do, lse, hd: int, s_valid: int,
                                     name: str = PACKED, out=None):
    """The backward kernels: (dq, dk, dv) from the forward's operands, its
    logsumexp and the output gradient, written into `out` (three tensors,
    possibly strided views of one buffer) or into new contiguous ones. In
    bf16 the kernels read q/k/v/do by TMA: every batch and time stride a
    multiple of 8 elements and every base 16-byte aligned (`_strides`
    raises otherwise)."""
    B, Tq, Tk, H = _check(q, k, v, hd, s_valid, do)
    if lse.dtype != torch.float32 or lse.shape != (B, H, Tq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous fp32 (B, H, Tq) tensor on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    if out is None:
        out = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                    for t in (q, k, v))
    dq, dk, dv = out
    if dq.shape != q.shape or dk.shape != k.shape or dv.shape != v.shape \
            or any(t.dtype != q.dtype or t.device != q.device for t in out):
        raise ValueError("dq/dk/dv must match q/k/v in shape, dtype and device")
    di = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    # bf16: the (B, H, Tq, 64) fp32 dq accumulator the kernels zero, add
    # into and round into dq
    dq_acc = (torch.empty((B, H, Tq, hd), dtype=torch.float32, device=q.device)
              if q.dtype == torch.bfloat16 else None)
    lib = _lib()
    err = lib.encoder_attention_bwd(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        None if dq_acc is None else dq_acc.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, Tq, Tk, s_valid,
        *_strides(q), *_strides(k), *_strides(v), *_strides(do),
        *_strides(dq), *_strides(dk), *_strides(dv), _build.stream_ptr(q))
    _build.check(lib, err, name + "_bwd")
    LAUNCHES[name + "_bwd"] += 1
    return dq, dk, dv


def _attn_forward(ctx, q, k, v, hd: int, s_valid: int, name: str):
    """Forward of the autograd Functions: the plain version on CPU tensors,
    the kernel with its logsumexp on CUDA ones; keeps hd, s_valid and the
    layout's name on ctx for the backward."""
    if q.device.type == "cpu":
        out, lse = dense_attention_packed_plain(q, k, v, hd, s_valid), None
    else:
        out, lse = _dense_attention_packed_cuda(q, k, v, hd, s_valid,
                                                with_lse=True, name=name)
    ctx.hd, ctx.s_valid, ctx.name = hd, s_valid, name
    return out, lse


def _attn_backward(ctx, q, k, v, lse, do, out=None):
    """(dq, dk, dv) of the autograd Functions: the plain version on CPU
    tensors, the backward kernel on CUDA ones (into `out` when given)."""
    do = do.contiguous()
    if q.device.type == "cpu":
        return dense_attention_packed_bwd_plain(q, k, v, do, ctx.hd, ctx.s_valid)
    return _dense_attention_packed_bwd_cuda(q, k, v, do, lse, ctx.hd, ctx.s_valid,
                                            ctx.name, out)


class DenseAttentionPacked(torch.autograd.Function):
    """Differentiable packed attention (the JAX `dense_attention_packed`
    custom_vjp): on CUDA tensors the forward kernel saves its logsumexp and
    the backward kernel computes (dq, dk, dv) from it; on CPU tensors the
    plain versions run."""

    @staticmethod
    def forward(ctx, q, k, v, hd: int, s_valid: int):
        out, lse = _attn_forward(ctx, q, k, v, hd, s_valid, PACKED)
        ctx.save_for_backward(q, k, v, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        return (*_attn_backward(ctx, q, k, v, lse, do), None, None)


class DenseAttention(torch.autograd.Function):
    """Differentiable (BH, T, hd) attention (the JAX `dense_attention`
    custom_vjp): the packed kernels with B' = BH and one head."""

    @staticmethod
    def forward(ctx, q, k, v, s_valid: int):
        out, lse = _attn_forward(ctx, q, k, v, q.shape[-1], s_valid, BH)
        ctx.save_for_backward(q, k, v, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        return (*_attn_backward(ctx, q, k, v, lse, do), None)


def _qkv_views(qkv: torch.Tensor, hd: int):
    """The q, k, v column blocks of a (B, T, 3D) buffer, as views."""
    D3 = qkv.shape[-1]
    if qkv.dim() != 3 or D3 % 3 or (D3 // 3) % hd:
        raise ValueError(f"qkv must be (B, T, 3·H·{hd}), got {tuple(qkv.shape)}")
    D = D3 // 3
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]


class DenseAttentionQKV(torch.autograd.Function):
    """Differentiable self-attention over one (B, T, 3D) qkv buffer (the JAX
    `dense_attention_qkv` custom_vjp): the forward reads the three column
    views, the backward writes dq, dk and dv into the three column views of
    one (B, T, 3D) gradient buffer."""

    @staticmethod
    def forward(ctx, qkv, hd: int):
        q, k, v = _qkv_views(qkv, hd)
        out, lse = _attn_forward(ctx, q, k, v, hd, qkv.shape[1], QKV)
        ctx.save_for_backward(qkv, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, lse = ctx.saved_tensors
        if qkv.device.type == "cpu":
            return dense_attention_qkv_bwd_plain(qkv, do.contiguous(), ctx.hd), None
        grad = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        _attn_backward(ctx, *_qkv_views(qkv, ctx.hd), lse, do,
                       out=_qkv_views(grad, ctx.hd))
        return grad, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def dense_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           hd: int, s_valid: int) -> torch.Tensor:
    """Attention over packed (B, T, H*hd) q/k/v, keys masked at col >=
    s_valid. CUDA tensors launch the kernel; CPU tensors take the plain
    version. Differentiable through DenseAttentionPacked when autograd
    needs it."""
    if _needs_grad(q, k, v):
        return DenseAttentionPacked.apply(q, k, v, hd, s_valid)
    if q.device.type == "cpu":
        return dense_attention_packed_plain(q, k, v, hd, s_valid)
    return _dense_attention_packed_cuda(q, k, v, hd, s_valid)[0]


def dense_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          s_valid: int) -> torch.Tensor:
    """Plain version of the (BH, T, hd) forward (`_fwd_kernel`): the packed
    plain version with one head, the same arithmetic."""
    return dense_attention_packed_plain(q, k, v, q.shape[-1], s_valid)


def dense_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              do: torch.Tensor, s_valid: int):
    """Plain version of the (BH, T, hd) backward (`_bwd_kernel`)."""
    return dense_attention_packed_bwd_plain(q, k, v, do, q.shape[-1], s_valid)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    s_valid: int) -> torch.Tensor:
    """Attention over (BH, T, hd) tensors, keys masked at col >= s_valid
    (the JAX `dense_attention`). CUDA tensors launch the kernel; CPU tensors
    take the plain version. Differentiable through DenseAttention."""
    if _needs_grad(q, k, v):
        return DenseAttention.apply(q, k, v, s_valid)
    if q.device.type == "cpu":
        return dense_attention_plain(q, k, v, s_valid)
    return _dense_attention_packed_cuda(q, k, v, q.shape[-1], s_valid, name=BH)[0]


def dense_attention_qkv_plain(qkv: torch.Tensor, hd: int) -> torch.Tensor:
    """Plain version of the fused-qkv forward: the packed plain version on
    the three column views, every row valid; (B, T, D)."""
    return dense_attention_packed_plain(*_qkv_views(qkv, hd), hd, qkv.shape[1])


def dense_attention_qkv_bwd_plain(qkv: torch.Tensor, do: torch.Tensor,
                                  hd: int) -> torch.Tensor:
    """Plain version of the fused-qkv backward: dq‖dk‖dv as one (B, T, 3D)
    tensor, the layout of the JAX VJP."""
    return torch.cat(dense_attention_packed_bwd_plain(
        *_qkv_views(qkv, hd), do, hd, qkv.shape[1]), dim=-1)


def dense_attention_qkv(qkv: torch.Tensor, hd: int) -> torch.Tensor:
    """Self-attention over one fused (B, T, 3·H·hd) qkv buffer, every row
    valid (the encoder's), returning (B, T, H·hd) packed (the JAX
    `dense_attention_qkv`). CUDA tensors launch the kernel on the three
    column views; CPU tensors take the plain version. Differentiable
    through DenseAttentionQKV."""
    if _needs_grad(qkv):
        return DenseAttentionQKV.apply(qkv, hd)
    if qkv.device.type == "cpu":
        return dense_attention_qkv_plain(qkv, hd)
    return _dense_attention_packed_cuda(*_qkv_views(qkv, hd), hd, qkv.shape[1],
                                        name=QKV)[0]


def _switch(name: str) -> bool:
    """An on/off environment switch, on unless set to 0/false/no/off; read
    at every call, never cached."""
    return os.environ.get(name, "1").lower() not in ("0", "false", "no", "off")


def _packed_default() -> bool:
    return _switch("ASR_TPU_DENSE_PACKED")


def _native_t_default() -> bool:
    return _switch("ASR_TPU_DENSE_NATIVE_T")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def fused_qkv_supported(H: int, hd: int, T: int) -> bool:
    """True when the kernels can take a fused (B, T, 3·H·hd) qkv buffer at
    this shape: the kernels' 64-dim heads, T >= 128 (as in JAX), and the
    packed, native-T layout switched on. The TPU's lane grouping and VMEM
    bound are not ported: the kernels take any head count and T."""
    return (hd == HEAD_DIM and T >= 128 and _packed_default()
            and _native_t_default())


def encoder_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """(B, Tq, H, hd) non-causal unmasked attention (the JAX function of the
    same name). By default a free reshape to the packed layout at the native
    T; ASR_TPU_DENSE_NATIVE_T=0 pads its rows to a multiple of 128;
    ASR_TPU_DENSE_PACKED=0 takes the (BH, T_p, hd) transpose, rows padded to
    a multiple of 128. Keys past Tk are masked (s_valid = Tk), padded query
    rows cut off. The switches are read at every call."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    if _packed_default():
        native = _native_t_default()
        Tq_p, Tk_p = (Tq, Tk) if native else (_round_up(Tq, 128), _round_up(Tk, 128))

        def prep(x, T_p):
            x = x.reshape(B, x.shape[1], H * hd)
            return F.pad(x, (0, 0, 0, T_p - x.shape[1])) if x.shape[1] != T_p else x

        out = dense_attention_packed(prep(q, Tq_p), prep(k, Tk_p), prep(v, Tk_p),
                                     hd, Tk)
        return out[:, :Tq].reshape(B, Tq, H, hd)
    Tq_p, Tk_p = _round_up(Tq, 128), _round_up(Tk, 128)

    def prep_bh(x, T_p):
        if x.shape[1] != T_p:
            x = F.pad(x, (0, 0, 0, 0, 0, T_p - x.shape[1]))
        return x.transpose(1, 2).reshape(B * H, T_p, hd)

    out = dense_attention(prep_bh(q, Tq_p), prep_bh(k, Tk_p), prep_bh(v, Tk_p), Tk)
    return out.reshape(B, H, Tq_p, hd).transpose(1, 2)[:, :Tq]


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("encoder_attention")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.encoder_attention_fwd.argtypes = [I, P, P, P, P, P, I, I, I, I, I,
                                              L, L, L, L, L, L, L, L, P]
        lib.encoder_attention_fwd.restype = I
        lib.encoder_attention_bwd.argtypes = [I] + [P] * 10 + [I] * 5 + [L] * 14 + [P]
        lib.encoder_attention_bwd.restype = I
        _LIB = lib
    return _LIB

"""Fused per-token decoder kernels: CUDA (csrc/decoder_fused.cu) + plain versions.

Counterpart of asr_finetune_tpu/ops/decoder_fused.py. Each decoder layer of
a decode step runs four wrappers, each replacing one Pallas kernel:

  fused_qkv   ← `fused_qkv` (:150; pl.pallas_call :195, `_qkv_kernel` :127)
  fused_attn  ← `fused_attn` (:310; pl.pallas_call :447, `_attn_kernel` :213),
                self mode (q given, keys at col > pos masked) and cross mode
                (q = (LN(x)@wq + bq)·hd^-0.5 computed inside, keys at
                col >= s_valid masked)
  fused_attn_beam ← `fused_attn_beam` (:548; pl.pallas_call :630,
                `_attn_beam_kernel` :484): beam search's self-attention
                over an unpermuted cache through an ancestry map
  fused_mlp   ← `fused_mlp` (:681; pl.pallas_call :738, `_mlp_kernel` :649)

Bound on the card: bytes. A call streams one layer's weights (and K/V rows),
a few flops per byte; the kernels are, for every bf16 call, tensor-core
products fed by TMA and an attention core (once per pass of up to 32 rows;
fused_attn_beam's core gathers each key row through the ancestry map), and
for fp32 split-K GEMVs (once per group of up to 8 rows) and a split-T
attention, all built to stream. The CUDA source says how.

fused_qkv writes k and v straight into a self cache when given one
(cache_k, cache_v, pos): the decode step's row pos of layer l, with no copy
after the call.

The position on the card: fused_qkv's cache row and self-mode fused_attn's
keys 0..pos also take pos as a one-element int64 tensor on x's device,
which the kernels read where they run, so that one CUDA graph of a decode
position (evaluation/decode.py) replays at every position. The self
attention core's grid then spans the whole cache, its chunks past pos only
taking their ticket; the outputs are the int position's, bit for bit. On
CPU tensors the plain versions read the value on the host.

Wrappers take unstacked per-layer weights (tests) or the full stacked
(L, ...) tensors plus `layer_idx` (the decode loop); the kernels read layer
l through a pointer offset, never through a copied slice. For CUDA tensors
a wrapper launches its kernel(s) or raises; CPU tensors take the plain
PyTorch version beside it. One wrapper call may launch more than one CUDA
kernel (bf16 fused_attn: the cross q product, the attention core with its
combine, the wo product, and so bf16 fused_attn_beam without q; fp32: the q
GEMV, the partials, their combine, the wo GEMV), and counts once in
LAUNCHES.

int8 weights (the JAX kernels' w*_scale option): any projection may be int8
({"w_q8", "w_scale"} of ops/quant.py) while its neighbours in the same call
are float, as in a merged-LoRA int8 base (adapted q/v float, the rest
int8). Pass the int8 weight with its per-output-channel fp32 scale ((1, N),
stacked (L, 1, N)); the product runs over the int8 values widened to the
activation dtype (exact) and the scale multiplies its fp32 sum before the
bias, GELU, q scale or residual, as the Pallas kernels do.

fused_attn's other options: int8 K/V (k_scale/v_scale, the per-(batch,
head) scales expanded over d: (B, d), stacked (L, B, d)) — K's scale folds
into q, V's into the accumulator, and the product runs in the activation
dtype (the Pallas kernel's compute dtype: fp32 in interpret mode, bf16
compiled); and kv_group = G, x with B·G rows over k/v with B, row r
attending KV row r // G (the beam hypotheses of one utterance sharing its
cross K/V). Neither kv_group nor fused_attn_beam's beam width is bounded
(the Pallas kernels take at most 8): a CUDA block serves up to 8 query rows
of a KV row, and a wider group takes more blocks.
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
_MLP_TILE = 64    # output columns per bf16 MLP block (csrc MLP_TILE): d, ff % 64
_MLP_MAX_D = 1280   # x's rows staged whole (csrc MLP_MAX_D): every Whisper width
_MLP_COUNTERS = 1024                 # split-K tickets per product kernel (csrc MLP_COUNTERS)
_MLP_WORK_FLOATS = 1 << 20           # split-K partial sums: 512 blocks x 32 rows x 64
_N_COUNTERS = 6                      # ticket regions: fc1, fc2, q, wo, the core, qkv
_PASS_ROWS = 32                      # rows a tensor-core pass (csrc MLP_MAX_ROWS)
_PART = HEAD_DIM + 4                 # a bf16 attention partial record (csrc PART)
_MIN_CHUNK = 64                      # the attention core's smallest chunk (csrc KV_BOX)

# wrapper launches on the card, by kernel name (chip_smoke.py reads them); a
# launch with any int8 weight counts under the name + "_int8". Cross
# attention counts by its KV options: "_group" (kv_group > 1), "_kv8" (int8
# K/V)
ATTN_CROSS = ("fused_attn_cross", "fused_attn_cross_group", "fused_attn_cross_kv8",
              "fused_attn_cross_group_kv8")
LAUNCHES = {f"{k}{v}": 0 for k in ("fused_qkv", "fused_attn_self", "fused_attn_beam",
                                  *ATTN_CROSS, "fused_mlp") for v in ("", "_int8")}
# the CUDA kernels the wrappers launch, as kernel_launches() counts them
KERNELS = ("gemv_kernel", "attn_partial_kernel", "attn_combine_kernel",
           "mlp_fc1_kernel", "mlp_fc2_kernel", "attn_q_kernel", "attn_chunk_kernel",
           "attn_wo_kernel", "qkv_kernel")


def attn_passes(rows: int, kv_group: int = 1) -> list:
    """The row counts of bf16 fused_attn's passes (csrc attn_tc): whole
    groups of kv_group rows, as many as fit in 32 rows, or 32 rows at a time
    of a wider group. Each pass is one launch of the attention core and of
    the wo product, and in cross mode of the q product. bf16 fused_attn_beam
    takes attn_passes(rows): its passes need not hold whole utterances."""
    out, r0 = [], 0
    while r0 < rows:
        if kv_group <= _PASS_ROWS:
            n = min(rows - r0, _PASS_ROWS // kv_group * kv_group)
        else:
            n = min(_PASS_ROWS, kv_group - r0 % kv_group)
        out.append(n)
        r0 += n
    return out


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _count(name: str, *scales) -> None:
    LAUNCHES[name + ("_int8" if any(s is not None for s in scales) else "")] += 1


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference chip_smoke.py holds the
# kernels against)
# ---------------------------------------------------------------------------

def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    """fp32 layer norm over the last axis (models/whisper.layer_norm) in the
    bf16 kernels' operations: the sum of x, then of the fp32 squares of
    (x - mean), each taken in fp64 and rounded once to fp32, times fp32(1/d);
    then ((x - mean) * rstd) * scale + bias, each step rounded alone. An fp32
    sum (torch's mean) may round a last bit otherwise, which at a bf16
    rounding boundary moves LN(x)'s bf16 value and a whole output row."""
    x32 = x.float()
    inv_d = torch.tensor(1.0 / x32.shape[-1], dtype=torch.float32)

    def mean(t):
        return t.double().sum(dim=-1, keepdim=True).float() * inv_d

    dv = x32 - mean(x32)
    return dv * torch.rsqrt(mean(dv * dv) + eps) * scale.float() + bias.float()


def _proj(h: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
          scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h (already in the activation dtype, as fp32) @ w cast to that dtype,
    fp32 accumulation: jnp.dot(h, w, preferred_element_type=f32); an int8 w
    (exact in any dtype) then takes its per-column scale."""
    y = torch.matmul(h, w.to(dtype).float())
    return y if scale is None else y * scale.reshape(-1).float()


def fused_qkv_plain(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, kv_dtype=None,
                    wq_scale=None, wk_scale=None, wv_scale=None):
    """One layer: x (B, d) → q (B, d) fp32 pre-scaled by hd^-0.5, k, v."""
    kv_dtype = kv_dtype or x.dtype
    h = _ln(x, ln_scale, ln_bias).to(x.dtype).float()
    q = (_proj(h, wq, x.dtype, wq_scale) + bq.float()) * HEAD_DIM ** -0.5
    k = _proj(h, wk, x.dtype, wk_scale).to(kv_dtype)
    v = (_proj(h, wv, x.dtype, wv_scale) + bv.float()).to(kv_dtype)
    return q, k, v


def _cross_q(x, ln_scale, ln_bias, wq, bq, wq_scale):
    h = _ln(x, ln_scale, ln_bias).to(x.dtype).float()
    return (_proj(h, wq, x.dtype, wq_scale) + bq.float()) * HEAD_DIM ** -0.5


def _attend(x, q, k, v, G=1, k_scale=None, v_scale=None):
    """Single-query attention of x's N = B·G rows over k/v (B, n, d), every
    key valid, row r attending KV row r // G: o (N, d) rounded to x's dtype,
    held as fp32. q (N, d) fp32 is cast to the K dtype, p to the V dtype;
    int8 k/v with scales (B, d): q times K's scale and p in x's dtype, V's
    scale on the accumulator before the division by l."""
    B, n, d = k.shape
    H = d // HEAD_DIM
    q = q.reshape(B, G, d)
    if k_scale is None:
        qh, p_dtype = q.to(k.dtype).float(), v.dtype
    else:
        qh, p_dtype = (q * k_scale.float()[:, None, :]).to(x.dtype).float(), x.dtype
    qh = qh.reshape(B, G, H, HEAD_DIM)
    kh = k.float().reshape(B, n, H, HEAD_DIM)
    vh = v.float().reshape(B, n, H, HEAD_DIM)
    s = torch.einsum("bghd,bthd->bght", qh, kh)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1)[..., None]
    pv = torch.einsum("bght,bthd->bghd", e.to(p_dtype).float(), vh)
    if v_scale is not None:
        pv = pv * v_scale.float().reshape(B, 1, H, HEAD_DIM)
    return (pv / l).reshape(B * G, d).to(x.dtype).float()


def _out_proj(x, o, wo, bo, wo_scale):
    out = _proj(o, wo, x.dtype, wo_scale) + bo.float() + x.float()
    return out.to(x.dtype)


def fused_attn_plain(x, k, v, wo, bo, q=None, n_valid=None, ln_scale=None,
                     ln_bias=None, wq=None, bq=None, wq_scale=None,
                     wo_scale=None, k_scale=None, v_scale=None, kv_group=1):
    """One layer: single-query attention of x's rows over k/v (B, T, d)
    restricted to keys t < n_valid, then o @ wo + bo + x. kv_group G: x has
    B·G rows, row r attends KV row r // G; k_scale/v_scale: int8 k/v."""
    if q is None:
        q = _cross_q(x, ln_scale, ln_bias, wq, bq, wq_scale)
    o = _attend(x, q, k[:, :n_valid], v[:, :n_valid], kv_group, k_scale, v_scale)
    return _out_proj(x, o, wo, bo, wo_scale)


def fused_attn_beam_plain(x, k, v, wo, bo, q, pos, ancestry, wo_scale=None):
    """One layer of beam self-attention: each hypothesis' history gathered
    from the unpermuted cache k/v (B·K, T, d) — position t of row b·K + j
    lives in row b·K + ancestry[b, j, t] — then fused_attn_plain's
    attention over keys 0..pos and o @ wo + bo + x."""
    B, K, _ = ancestry.shape
    n = int(pos) + 1
    base = torch.arange(B, device=x.device)[:, None, None] * K
    rows = (base + ancestry[:, :, :n].long()).reshape(B * K, n)
    cols = torch.arange(n, device=x.device)[None, :]
    o = _attend(x, q, k[rows, cols], v[rows, cols])
    return _out_proj(x, o, wo, bo, wo_scale)


def fused_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, w1_scale=None,
                    w2_scale=None):
    """One layer: x (B, d) → gelu(LN(x) @ w1 + b1) @ w2 + b2 + x."""
    h = _ln(x, ln_scale, ln_bias).to(x.dtype).float()
    g = torch.nn.functional.gelu(_proj(h, w1, x.dtype, w1_scale) + b1.float())  # exact erf
    out = _proj(g.to(x.dtype).float(), w2, x.dtype, w2_scale) + b2.float() + x.float()
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


def _weight(ptr, w: torch.Tensor, scale: Optional[torch.Tensor], T,
            shape) -> Tuple[int, Optional[int]]:
    """(weight address, scale address or None): a float weight in the
    activation dtype T, or an int8 weight with its fp32 (1, N) scale
    ((N,) accepted unstacked; stacked (L, 1, N))."""
    if scale is None:
        return ptr(w, 2, T, shape), None
    if scale.dim() == 1:
        scale = scale.reshape(1, -1)
    return ptr(w, 2, torch.int8, shape), ptr(scale, 2, torch.float32, (1, shape[1]))


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
              kv_dtype=None, layer_idx=None, cache_k=None, cache_v=None, pos=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, d) → (q (B, d) fp32 pre-scaled by hd^-0.5, k (B, d), v (B, d)).

    With layer_idx the weights come stacked ((L, d, d), biases (L, d)) and
    the kernel reads layer layer_idx in place. w*_scale: an int8 weight's
    per-output-channel scale (the module docstring). cache_k, cache_v and
    pos: the self cache ((L, B, T, d) read at layer_idx, or (B, T, d)) whose
    row pos takes k and v (in the cache's dtype) in place of new tensors; k
    and v are then views of those rows, equal to what the call without a
    cache returns. With pos on the card (the module docstring) the rows are
    written where the kernel reads pos, and (q, None, None) is returned."""
    if (cache_k is None) != (cache_v is None) or (cache_k is None) != (pos is None):
        raise ValueError("fused_qkv: pass cache_k, cache_v and pos together")
    pos_dev = pos if isinstance(pos, torch.Tensor) else None
    if pos_dev is not None:
        _check_pos(pos_dev, x)
        if x.device.type == "cpu":
            return fused_qkv(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, wq_scale, wk_scale,
                             wv_scale, kv_dtype, layer_idx, cache_k, cache_v,
                             int(pos_dev))[0], None, None
        pos = 0   # the kernel takes the layer's row 0 and adds the position
    if cache_k is not None:
        kv_dtype = kv_dtype or cache_k.dtype
        rows = tuple(_cache_row(c, layer_idx, pos, x.shape[0], kv_dtype)
                     for c in (cache_k, cache_v))
    else:
        rows = None
    if x.device.type == "cpu":
        q, k, v = fused_qkv_plain(
            x, _at(ln_scale, layer_idx, 1), _at(ln_bias, layer_idx, 1),
            _at(wq, layer_idx, 2), _at(bq, layer_idx, 1),
            _at(wk, layer_idx, 2), _at(wv, layer_idx, 2),
            _at(bv, layer_idx, 1), kv_dtype, _at(wq_scale, layer_idx, 2),
            _at(wk_scale, layer_idx, 2), _at(wv_scale, layer_idx, 2))
        if rows is None:
            return q, k, v
        rows[0].copy_(k)   # the JAX step's dynamic_update_slice of the cache
        rows[1].copy_(v)
        return (q, *rows)
    if pos_dev is None:
        return _fused_qkv_cuda(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, kv_dtype,
                               layer_idx, wq_scale, wk_scale, wv_scale, rows)
    layers = tuple(_at(c, layer_idx, 3) for c in (cache_k, cache_v))
    q, _, _ = _fused_qkv_cuda(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, kv_dtype,
                              layer_idx, wq_scale, wk_scale, wv_scale, rows,
                              (pos_dev, layers))
    return q, None, None


def _check_pos(pos: torch.Tensor, x: torch.Tensor) -> None:
    """The position on the card: one int64 on x's device."""
    if pos.dtype != torch.int64 or pos.numel() != 1 or pos.device != x.device:
        raise ValueError(f"pos on the card: one int64 on {x.device}, got "
                         f"{tuple(pos.shape)} {pos.dtype} on {pos.device}")


def _cache_row(cache: torch.Tensor, layer_idx, pos, rows: int, dtype) -> torch.Tensor:
    """Row `pos` of a self cache at layer_idx: a (rows, d) view."""
    c = _at(cache, layer_idx, 3)
    if c.dim() != 3 or c.shape[0] != rows or c.dtype != dtype:
        raise ValueError(f"fused_qkv: cache {tuple(cache.shape)} {cache.dtype} at layer "
                         f"{layer_idx} for {rows} rows of {dtype}")
    if not 0 <= int(pos) < c.shape[1]:
        raise IndexError(f"fused_qkv: pos {pos} outside a cache of {c.shape[1]}")
    return c[:, int(pos)]


def _fused_qkv_cuda(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, kv_dtype,
                    layer_idx, wq_scale, wk_scale, wv_scale, rows, on_card=None):
    """rows: the cache rows k and v go to, or None. on_card: (pos, the
    layer's (B, T, d) caches) for the position on the card, rows then the
    layer's row 0."""
    B, d = _check_x(x, "fused_qkv")
    pos_dev, layers = on_card or (None, None)
    if (kv_dtype or x.dtype) != x.dtype:
        raise TypeError("the CUDA fused_qkv writes k/v in x's dtype")
    T, f32 = x.dtype, torch.float32
    if T == torch.bfloat16 and d > _MLP_MAX_D:
        raise ValueError(f"fused_qkv: d={d} above {_MLP_MAX_D}: the tensor-core kernel "
                         "stages x's rows whole in shared memory")
    if rows is not None and any(r.device != x.device or r.stride(1) != 1 for r in rows):
        raise ValueError("fused_qkv: the cache must lie on x's device, d innermost")
    ptr = functools.partial(_ptr, layer_idx=layer_idx, device=x.device)
    q = torch.empty((B, d), dtype=f32, device=x.device)
    wq_p, sq_p = _weight(ptr, wq, wq_scale, T, (d, d))
    wk_p, sk_p = _weight(ptr, wk, wk_scale, T, (d, d))
    wv_p, sv_p = _weight(ptr, wv, wv_scale, T, (d, d))
    ln_s, ln_b = ptr(ln_scale, 1, f32, (d,)), ptr(ln_bias, 1, f32, (d,))
    bq_p, bv_p = ptr(bq, 1, T, (d,)), ptr(bv, 1, T, (d,))
    lib = _lib()
    if T == torch.bfloat16:
        # the tensor-core route reads the stacked bases at the layer and
        # writes k and v where they go: the cache's rows, or new tensors
        k, v = rows if rows is not None else (torch.empty_like(x), torch.empty_like(x))
        (lq, n_q), (lk, n_k), (lv, n_v) = (_stacked(w, layer_idx) for w in (wq, wk, wv))
        work, counters = _workspace(x.device)
        err = lib.fused_qkv_tc_fwd(
            x.data_ptr(), ln_s, ln_b, wq.data_ptr(), bq_p, sq_p, lq, n_q,
            wk.data_ptr(), sk_p, lk, n_k, wv.data_ptr(), bv_p, sv_p, lv, n_v,
            q.data_ptr(), k.data_ptr(), k.stride(0), v.data_ptr(), v.stride(0),
            None if pos_dev is None else pos_dev.data_ptr(),
            0 if layers is None else layers[0].shape[1],
            work.data_ptr() + 4 * _MLP_WORK_FLOATS, _MLP_WORK_FLOATS,
            counters.data_ptr() + 4 * 5 * _MLP_COUNTERS, B, d, _build.stream_ptr(x))
    else:
        k, v = torch.empty_like(x), torch.empty_like(x)
        err = lib.fused_qkv_fwd(
            _build.dtype_code(x), x.data_ptr(), ln_s, ln_b, wq_p, bq_p, wk_p, wv_p, bv_p,
            sq_p, sk_p, sv_p, q.data_ptr(), k.data_ptr(), v.data_ptr(), B, d,
            _build.stream_ptr(x))
    _build.check(lib, err, "fused_qkv")
    _count("fused_qkv", sq_p, sk_p, sv_p)
    if rows is not None and T != torch.bfloat16:   # the GEMV route's k/v into the cache
        if pos_dev is not None:
            for c, new in zip(layers, (k, v)):
                c.index_copy_(1, pos_dev, new[:, None])
        else:
            rows[0].copy_(k)
            rows[1].copy_(v)
        k, v = rows
    return q, k, v


def fused_attn(x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               wo: torch.Tensor, bo: torch.Tensor,
               q: Optional[torch.Tensor] = None, pos=None,
               s_valid: Optional[int] = None,
               ln_scale=None, ln_bias=None, wq=None, bq=None,
               k_scale=None, v_scale=None, wq_scale=None, wo_scale=None,
               layer_idx=None, kv_group: int = 1) -> torch.Tensor:
    """Single-query attention over a dense KV cache + output proj + residual.

    x (N, d) residual input; k/v (B, T, d), or stacked (L, B, T, d) with
    layer_idx, B = N / kv_group. Self-attention: pass q (N, d) fp32 from
    fused_qkv and pos — keys at col > pos are masked; pos may be the position
    on the card (the module docstring). Cross-attention: pass
    ln_scale/ln_bias/wq/bq instead (q computed inside) and s_valid = the
    real source length (the padded tail beyond it is masked). kv_group G:
    consecutive groups of G rows of x share KV row r // G.
    k_scale/v_scale: int8 k/v with per-(batch, head) fp32 scales expanded
    over d, (B, d) or stacked (L, B, d). wq_scale (cross mode) and wo_scale:
    int8 weights' per-output-channel scales."""
    self_mode = q is not None
    if self_mode == (s_valid is not None) or (pos is None) == self_mode:
        raise ValueError("fused_attn: pass q and pos (self) or s_valid and "
                         "the ln/wq/bq operands (cross)")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("fused_attn: int8 K/V takes both k_scale and v_scale")
    G = int(kv_group)
    if G < 1 or x.shape[0] % G:
        raise ValueError(f"fused_attn: kv_group {G} must be positive and divide "
                         f"the {x.shape[0]} rows of x")
    if k.shape[-3] != x.shape[0] // G:
        raise ValueError(f"fused_attn: k/v batch dim {k.shape[-3]} != x rows "
                         f"{x.shape[0]} / kv_group {G}")
    pos_dev = pos if isinstance(pos, torch.Tensor) else None
    if pos_dev is not None:
        _check_pos(pos_dev, x)
        if x.device.type == "cpu":
            pos, pos_dev = int(pos_dev), None
    # on the card the kernel reads the position and bounds the grid by the cache
    n_valid = (k.shape[-2] if pos_dev is not None else int(pos) + 1) if self_mode \
        else int(s_valid)
    if x.device.type == "cpu":
        return fused_attn_plain(
            x, _at(k, layer_idx, 3), _at(v, layer_idx, 3),
            _at(wo, layer_idx, 2), _at(bo, layer_idx, 1), q=q,
            n_valid=n_valid, ln_scale=_at(ln_scale, layer_idx, 1),
            ln_bias=_at(ln_bias, layer_idx, 1), wq=_at(wq, layer_idx, 2),
            bq=_at(bq, layer_idx, 1),
            wq_scale=None if self_mode else _at(wq_scale, layer_idx, 2),
            wo_scale=_at(wo_scale, layer_idx, 2),
            k_scale=_at(k_scale, layer_idx, 2), v_scale=_at(v_scale, layer_idx, 2),
            kv_group=G)
    return _fused_attn_cuda(x, k, v, wo, bo, q, n_valid, ln_scale, ln_bias,
                            wq, bq, layer_idx, wq_scale, wo_scale, k_scale,
                            v_scale, G, pos_dev)


def _attn_scratch(x, T_len):
    """(part, o_buf, out) of a GEMV-route attention call over a cache of
    T_len."""
    N, d = x.shape
    part = torch.empty((N, d // HEAD_DIM, -(-T_len // CHUNK), HEAD_DIM + 2),
                       dtype=torch.float32, device=x.device)
    return part, torch.empty_like(x), torch.empty_like(x)


def _stacked(w: torch.Tensor, layer_idx, ndim: int = 2) -> Tuple[int, int]:
    """(layer, L) of an operand the kernel reads at `layer` of its stacked
    base: a stacked (L, ...) one at layer_idx, or one layer's (rank `ndim`)
    as (0, 1)."""
    return (layer_idx, w.shape[0]) if w.dim() == ndim + 1 else (0, 1)


def _fused_attn_cuda(x, k, v, wo, bo, q, n_valid, ln_scale, ln_bias, wq, bq,
                     layer_idx, wq_scale, wo_scale, k_scale, v_scale, G, pos_dev=None):
    """pos_dev: self mode's position on the card (n_valid then the cache's
    length)."""
    self_mode = q is not None
    N, d = _check_x(x, "fused_attn")
    T, f32 = x.dtype, torch.float32
    ptr = functools.partial(_ptr, layer_idx=layer_idx, device=x.device)
    T_len = k.shape[-2]
    B = N // G
    if not 1 <= n_valid <= T_len:
        raise ValueError(f"fused_attn: {n_valid} valid keys for a cache of {T_len}")
    if T == torch.bfloat16 and d > _MLP_MAX_D:
        raise ValueError(f"fused_attn: d={d} above {_MLP_MAX_D}: the tensor-core q "
                         "product stages x's rows whole in shared memory")
    if self_mode:
        if q.shape != (N, d) or q.dtype != f32 or not q.is_contiguous():
            raise ValueError("fused_attn: q must be a contiguous (N, d) fp32 tensor")
        q_ptr, ln_s, ln_b, q_buf = q.data_ptr(), None, None, None
        wq_p = sq_p = bq_p = None
    else:
        q_buf = torch.empty((N, d), dtype=f32, device=x.device)
        q_ptr = None
        ln_s = ptr(ln_scale, 1, f32, (d,))
        ln_b = ptr(ln_bias, 1, f32, (d,))
        wq_p, sq_p = _weight(ptr, wq, wq_scale, T, (d, d))
        bq_p = ptr(bq, 1, T, (d,))
    kv_dtype = T if k_scale is None else torch.int8
    ks_p = None if k_scale is None else ptr(k_scale, 2, f32, (B, d))
    vs_p = None if v_scale is None else ptr(v_scale, 2, f32, (B, d))
    wo_p, so_p = _weight(ptr, wo, wo_scale, T, (d, d))
    k_p = ptr(k, 3, kv_dtype, (B, T_len, d))
    v_p = ptr(v, 3, kv_dtype, (B, T_len, d))
    q_buf_p = None if q_buf is None else q_buf.data_ptr()
    pos_p = None if pos_dev is None else pos_dev.data_ptr()
    out = torch.empty_like(x)
    lib = _lib()
    if T == torch.bfloat16:
        # the tensor-core route reads the stacked bases at the layer
        part = torch.empty((N, d // HEAD_DIM, -(-T_len // _MIN_CHUNK), _PART),
                           dtype=f32, device=x.device)
        o_buf = torch.empty_like(x)
        lo, n_o = _stacked(wo, layer_idx)
        lq, n_q = (0, 1) if self_mode else _stacked(wq, layer_idx)
        lkv, n_kv = _stacked(k, layer_idx, 3)
        work, counters = _workspace(x.device)
        err = lib.fused_attn_tc_fwd(
            x.data_ptr(), q_ptr, ln_s, ln_b, None if self_mode else wq.data_ptr(), bq_p,
            sq_p, lq, n_q, k.data_ptr(), v.data_ptr(), ks_p, vs_p, lkv, n_kv,
            wo.data_ptr(), ptr(bo, 1, T, (d,)), so_p, lo, n_o, q_buf_p, part.data_ptr(),
            o_buf.data_ptr(), out.data_ptr(), work.data_ptr(), _MLP_WORK_FLOATS,
            counters.data_ptr(), N, T_len, d, n_valid, pos_p, G, _build.stream_ptr(x))
    else:
        part, o_buf, _ = _attn_scratch(x, T_len)
        err = lib.fused_attn_fwd(
            _build.dtype_code(x), x.data_ptr(), q_ptr, ln_s, ln_b, wq_p, bq_p, k_p, v_p,
            ks_p, vs_p, wo_p, ptr(bo, 1, T, (d,)), sq_p, so_p, q_buf_p, part.data_ptr(),
            o_buf.data_ptr(), out.data_ptr(), N, T_len, d, n_valid, pos_p, G,
            _build.stream_ptr(x))
    _build.check(lib, err, "fused_attn")
    _count("fused_attn_self" if self_mode else ATTN_CROSS[(G > 1) + 2 * (k_scale is not None)],
           sq_p, so_p)
    return out


def fused_attn_beam(x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    wo: torch.Tensor, bo: torch.Tensor, q: torch.Tensor, pos,
                    ancestry: torch.Tensor, wo_scale=None,
                    layer_idx=None) -> torch.Tensor:
    """Beam self-attention over an unpermuted cache + output proj + residual.

    x/q (B·K, d), q fp32 from fused_qkv; k/v the cache rows (B·K, T, d), or
    stacked (L, B·K, T, d) with layer_idx; ancestry (B, K, T) int32: the
    beam row whose cache slot t holds hypothesis (b, k)'s key at position t.
    Keys at col > pos are masked. wo_scale: an int8 wo's per-output-channel
    scale."""
    N, d = x.shape
    B, K, T_anc = ancestry.shape
    if N != B * K:
        raise ValueError(f"fused_attn_beam: {N} rows for ancestry {tuple(ancestry.shape)}")
    T_len = k.shape[-2]
    if T_anc != T_len or k.shape[-3] != N:
        raise ValueError(f"fused_attn_beam: cache {tuple(k.shape)} for ancestry "
                         f"{tuple(ancestry.shape)}")
    if x.device.type == "cpu":
        return fused_attn_beam_plain(
            x, _at(k, layer_idx, 3), _at(v, layer_idx, 3), _at(wo, layer_idx, 2),
            _at(bo, layer_idx, 1), q, pos, ancestry, _at(wo_scale, layer_idx, 2))
    N, d = _check_x(x, "fused_attn_beam")
    n_valid = int(pos) + 1
    if not 1 <= n_valid <= T_len:
        raise ValueError(f"fused_attn_beam: {n_valid} valid keys for a cache of {T_len}")
    if q.shape != (N, d) or q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError("fused_attn_beam: q must be a contiguous (N, d) fp32 tensor")
    if ancestry.dtype != torch.int32 or not ancestry.is_contiguous() \
            or ancestry.device != x.device:
        raise ValueError("fused_attn_beam: ancestry must be a contiguous int32 "
                         "tensor on x's device")
    T = x.dtype
    ptr = functools.partial(_ptr, layer_idx=layer_idx, device=x.device)
    wo_p, so_p = _weight(ptr, wo, wo_scale, T, (d, d))
    k_p, v_p = ptr(k, 3, T, (N, T_len, d)), ptr(v, 3, T, (N, T_len, d))
    bo_p = ptr(bo, 1, T, (d,))
    lib = _lib()
    if T == torch.bfloat16:
        # the attention core in beam mode and the wo product, reading the
        # stacked bases at the layer, in passes of attn_passes(N)
        if d > _MLP_MAX_D:
            raise ValueError(f"fused_attn_beam: d={d} above {_MLP_MAX_D}: the tensor-core "
                             "wo product's tile")
        part = torch.empty((N, d // HEAD_DIM, -(-T_len // _MIN_CHUNK), _PART),
                           dtype=torch.float32, device=x.device)
        o_buf, out = torch.empty_like(x), torch.empty_like(x)
        (lkv, n_kv), (lo, n_o) = _stacked(k, layer_idx, 3), _stacked(wo, layer_idx)
        work, counters = _workspace(x.device)
        err = lib.fused_attn_beam_tc_fwd(
            x.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), lkv, n_kv,
            ancestry.data_ptr(), wo.data_ptr(), bo_p, so_p, lo, n_o, part.data_ptr(),
            o_buf.data_ptr(), out.data_ptr(), work.data_ptr(), _MLP_WORK_FLOATS,
            counters.data_ptr(), N, T_len, d, n_valid, K, _build.stream_ptr(x))
    else:
        part, o_buf, out = _attn_scratch(x, T_len)
        err = lib.fused_attn_beam_fwd(
            _build.dtype_code(x), x.data_ptr(), q.data_ptr(), k_p, v_p, ancestry.data_ptr(),
            wo_p, bo_p, so_p, part.data_ptr(), o_buf.data_ptr(), out.data_ptr(), N, T_len, d,
            n_valid, K, _build.stream_ptr(x))
    _build.check(lib, err, "fused_attn_beam")
    _count("fused_attn_beam", so_p)
    return out


def fused_mlp(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, w1_scale=None, w2_scale=None,
              layer_idx=None) -> torch.Tensor:
    """x (B, d) → ln → fc1 (d, ff) → exact GELU → fc2 (ff, d) → + x. With
    layer_idx the weights come stacked ((L, d, ff) etc.). w1_scale /
    w2_scale: int8 weights' per-output-channel scales."""
    if x.device.type == "cpu":
        return fused_mlp_plain(
            x, _at(ln_scale, layer_idx, 1), _at(ln_bias, layer_idx, 1),
            _at(w1, layer_idx, 2), _at(b1, layer_idx, 1),
            _at(w2, layer_idx, 2), _at(b2, layer_idx, 1),
            _at(w1_scale, layer_idx, 2), _at(w2_scale, layer_idx, 2))
    return _fused_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, layer_idx,
                           w1_scale, w2_scale)


_WORK = {}


def _workspace(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kernels' split-K partial sums and ticket counters on
    `device` (fc1, fc2, q, wo, the attention core, qkv: 1024 tickets each;
    the sums: fused_mlp's and fused_attn's, then qkv's own), made once: the
    counters start at 0 and every call leaves them so (the last block of a
    tile, or of a row's chunks, resets its ticket), and a call touches
    either only after the kernels before it have finished."""
    ws = _WORK.get(device)
    if ws is None:
        ws = (torch.empty(2 * _MLP_WORK_FLOATS, dtype=torch.float32, device=device),
              torch.zeros(_N_COUNTERS * _MLP_COUNTERS, dtype=torch.int32, device=device))
        _WORK[device] = ws
    return ws


def _fused_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, layer_idx, w1_scale,
                    w2_scale):
    B, d = _check_x(x, "fused_mlp")
    T, f32 = x.dtype, torch.float32
    ptr = functools.partial(_ptr, layer_idx=layer_idx, device=x.device)
    ff = w1.shape[-1]
    tile = _MLP_TILE if T == torch.bfloat16 else _NB
    if ff % tile:
        raise ValueError(f"fused_mlp: ff={ff} is not a multiple of {tile} (the "
                         f"{'tensor-core' if tile == _MLP_TILE else 'GEMV'} kernel's "
                         "column tile)")
    if T == torch.bfloat16 and d > _MLP_MAX_D:
        raise ValueError(f"fused_mlp: d={d} above {_MLP_MAX_D}: the tensor-core kernel "
                         "stages x's rows whole in shared memory")
    g = torch.empty((B, ff), dtype=T, device=x.device)
    out = torch.empty_like(x)
    _, s1_p = _weight(ptr, w1, w1_scale, T, (d, ff))   # checks, layer offsets
    _, s2_p = _weight(ptr, w2, w2_scale, T, (ff, d))
    (l1, n1), (l2, n2) = _stacked(w1, layer_idx), _stacked(w2, layer_idx)
    work, counters = _workspace(x.device)
    lib = _lib()
    err = lib.fused_mlp_fwd(
        _build.dtype_code(x), x.data_ptr(),
        ptr(ln_scale, 1, f32, (d,)),
        ptr(ln_bias, 1, f32, (d,)),
        w1.data_ptr(), ptr(b1, 1, T, (ff,)), w2.data_ptr(), ptr(b2, 1, T, (d,)),
        s1_p, s2_p, g.data_ptr(), out.data_ptr(), work.data_ptr(), _MLP_WORK_FLOATS,
        counters.data_ptr(), B, d, ff, l1, n1, l2, n2, _build.stream_ptr(x))
    _build.check(lib, err, "fused_mlp")
    _count("fused_mlp", s1_p, s2_p)
    return out


def kernel_launches() -> dict:
    """Launches of each CUDA kernel of csrc/decoder_fused.cu since
    reset_kernel_launches(), counted by the library where it launches them:
    a wrapper call may launch several (bf16 fused_attn: attn_q_kernel in
    cross mode, attn_chunk_kernel and attn_wo_kernel once per pass of
    attn_passes, and so bf16 fused_attn_beam, its passes attn_passes(N);
    fp32 fused_attn and fused_attn_beam: the cross q GEMV, the partials, the
    combine, the wo GEMV, a GEMV once per group of 8 rows;
    bf16 fused_mlp: mlp_fc1_kernel and mlp_fc2_kernel once per pass of up
    to 32 rows; bf16 fused_qkv: qkv_kernel once per pass of up to 32 rows,
    fp32 the GEMV once per group of 8). A replayed CUDA graph's launches
    count at each replay (credit_launches)."""
    counts = (ctypes.c_longlong * len(KERNELS))()
    _lib().kernel_launches(counts)
    return {k: n + _CREDIT.get(k, 0) for k, n in zip(KERNELS, counts)}


def reset_kernel_launches() -> None:
    _lib().reset_kernel_launches()
    _CREDIT.clear()


_CREDIT = {}   # kernel_launches()' launches made by graph replays, not by the library


def credit_launches(kernels: dict, wrappers: dict, times: int) -> None:
    """Count a CUDA graph's launches `times` times: its kernels in
    kernel_launches(), its wrapper calls in LAUNCHES. A capture counts its
    launches where the wrappers make them, and runs none, so it credits
    them back once (times = -1); each replay credits them once."""
    for k, n in kernels.items():
        _CREDIT[k] = _CREDIT.get(k, 0) + n * times
    for k, n in wrappers.items():
        LAUNCHES[k] += n * times


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("decoder_fused")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_qkv_fwd.argtypes = [I] + [P] * 14 + [I, I, P]
        lib.fused_attn_fwd.argtypes = [I] + [P] * 18 + [I] * 4 + [P, I, P]
        lib.fused_attn_tc_fwd.argtypes = ([P] * 7 + [I, I] + [P] * 4 + [I, I] + [P] * 3
                                          + [I, I] + [P] * 5 + [ctypes.c_longlong, P]
                                          + [I] * 4 + [P, I, P])
        lib.fused_attn_beam_fwd.argtypes = [I] + [P] * 11 + [I] * 5 + [P]
        LL = ctypes.c_longlong
        lib.fused_attn_beam_tc_fwd.argtypes = ([P] * 4 + [I, I] + [P] * 4 + [I, I] + [P] * 4
                                               + [LL, P] + [I] * 5 + [P])
        lib.fused_qkv_tc_fwd.argtypes = ([P] * 6 + [I, I] + [P] * 2 + [I, I] + [P] * 3
                                         + [I, I] + [P] * 2
                                         + [LL, P, LL, P, I, P, LL, P, I, I, P])
        lib.fused_mlp_fwd.argtypes = ([I] + [P] * 12 + [ctypes.c_longlong, P]
                                      + [I] * 7 + [P])
        for fn in (lib.fused_qkv_fwd, lib.fused_qkv_tc_fwd, lib.fused_attn_fwd,
                   lib.fused_attn_tc_fwd, lib.fused_attn_beam_fwd, lib.fused_attn_beam_tc_fwd,
                   lib.fused_mlp_fwd):
            fn.restype = I
        lib.kernel_launches.argtypes, lib.kernel_launches.restype = [P], None
        lib.reset_kernel_launches.argtypes, lib.reset_kernel_launches.restype = [], None
        _LIB = lib
    return _LIB

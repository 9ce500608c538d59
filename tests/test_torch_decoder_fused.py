"""Port parity: asr_finetune_tpu_torch.ops.decoder_fused against the JAX
Pallas kernels (asr_finetune_tpu.ops.decoder_fused, interpret mode on CPU).

The same numpy inputs go through both at fp32; on CPU tensors the port's
wrappers run their plain PyTorch versions, which chip_smoke.py holds the
CUDA kernels against on the card. Tolerance 2e-5: the JAX kernel tests'.
Shapes follow tests/test_decoder_fused.py (d=256, 4 heads of 64); weights
are scaled by 1/sqrt(fan_in), as the model's init, so outputs are O(1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.ops import decoder_fused as JDF
from asr_finetune_tpu_torch.ops import decoder_fused as TDF
from asr_finetune_tpu_torch.ops import quant as TQ

D, B, T, S, FF, L = 256, 3, 256, 384, 512, 3
TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape, scale=0.3, offset=0.0):
    return (offset + scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


def _layered(rng, stacked, *shape, **kw):
    """(L, *shape) when stacked, else (*shape)."""
    return _rand(rng, *(((L,) if stacked else ()) + shape), **kw)


@pytest.mark.parametrize("stacked", [False, True])
def test_fused_qkv(stacked):
    rng = np.random.default_rng(0)
    li = 2 if stacked else None
    x = _rand(rng, B, D, scale=1.0)
    lns = _layered(rng, stacked, D, scale=0.1, offset=1.0)
    lnb = _layered(rng, stacked, D, scale=0.1)
    wq, wk, wv = (_layered(rng, stacked, D, D, scale=D ** -0.5) for _ in range(3))
    bq, bv = _layered(rng, stacked, D), _layered(rng, stacked, D)
    args = (x, lns, lnb, wq, bq, wk, wv, bv)
    ref = JDF.fused_qkv(*map(_j, args), layer_idx=li)
    out = TDF.fused_qkv(*map(_t, args), layer_idx=li)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    assert out[0].dtype == torch.float32


def _qkv_operands(rng, rows, weights):
    """x (rows, D) and stacked (L, ...) fused_qkv operands; weights "float",
    "int8" (q, k, v int8 with per-channel scales) or "mixed" (a merged-LoRA
    base: k int8 beside float q and v), the same numpy arrays for both."""
    x = _rand(rng, rows, D, scale=1.0)
    lns = _layered(rng, True, D, scale=0.1, offset=1.0)
    lnb = _layered(rng, True, D, scale=0.1)
    wq, wk, wv = (_layered(rng, True, D, D, scale=D ** -0.5) for _ in range(3))
    bq, bv = _layered(rng, True, D), _layered(rng, True, D)
    int8 = {"float": "", "int8": "qkv", "mixed": "k"}[weights]
    scales = {}
    if "q" in int8:
        wq, scales["wq_scale"] = _int8_weight(wq)
    if "k" in int8:
        wk, scales["wk_scale"] = _int8_weight(wk)
    if "v" in int8:
        wv, scales["wv_scale"] = _int8_weight(wv)
    return (x, lns, lnb, wq, bq, wk, wv, bv), scales


@pytest.mark.parametrize("weights", ["float", "int8", "mixed"])
@pytest.mark.parametrize("rows", [1, 16, 33])
def test_fused_qkv_rows(rows, weights):
    """fused_qkv at the row counts the card's tensor-core kernel serves in
    one pass (1, 16) and in two (33), stacked weights at layer 1, float,
    int8 or mixed q/k/v (the same numpy int8 arrays on both sides)."""
    rng = np.random.default_rng(40 + rows)
    args, scales = _qkv_operands(rng, rows, weights)
    ref = JDF.fused_qkv(*map(_j, args), layer_idx=1, **{k: _j(v) for k, v in scales.items()})
    out = TDF.fused_qkv(*map(_t, args), layer_idx=1, **{k: _t(v) for k, v in scales.items()})
    for o, r in zip(out, ref):
        assert o.shape == (rows, D)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("weights", ["float", "mixed"])
@pytest.mark.parametrize("stacked", [False, True])
def test_fused_qkv_writes_the_cache(stacked, weights):
    """The cache form: k and v go into row pos of the self cache (layer 1
    of an (L, B, T, d) cache, or a (B, T, d) one), the call returns JAX
    fused_qkv's (q, k, v) with k and v views of those rows, and no other
    element of the cache changes."""
    rng = np.random.default_rng(7)
    args, scales = _qkv_operands(rng, B, weights)
    li, pos = (1 if stacked else None), 37
    if not stacked:
        args = args[:1] + tuple(a[1] for a in args[1:])
        scales = {k: v[1] for k, v in scales.items()}
    ck, cv = (_t(_layered(rng, stacked, B, T, D)) for _ in range(2))
    ck0, cv0 = ck.clone(), cv.clone()
    ref = JDF.fused_qkv(*map(_j, args), layer_idx=li, **{k: _j(v) for k, v in scales.items()})
    q, k, v = TDF.fused_qkv(*map(_t, args), layer_idx=li, cache_k=ck, cache_v=cv, pos=pos,
                            **{k_: _t(v_) for k_, v_ in scales.items()})
    for o, r in zip((q, k, v), ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    at = (lambda c: c[li]) if stacked else (lambda c: c)
    assert k.data_ptr() == at(ck)[:, pos].data_ptr()
    assert torch.equal(at(ck)[:, pos], k) and torch.equal(at(cv)[:, pos], v)
    for c, c0 in ((ck, ck0), (cv, cv0)):
        at(c)[:, pos] = at(c0)[:, pos]
        assert torch.equal(c, c0)


def test_fused_qkv_cache_operands_are_checked():
    """cache_k, cache_v and pos come together, at the rows and dtype of the
    call, pos inside the cache."""
    rng = np.random.default_rng(8)
    args, _ = _qkv_operands(rng, B, "float")
    args = tuple(map(_t, args))
    ck = torch.zeros(L, B, T, D)
    with pytest.raises(ValueError, match="together"):
        TDF.fused_qkv(*args, layer_idx=0, cache_k=ck, pos=0)
    with pytest.raises(ValueError, match="rows"):
        TDF.fused_qkv(*args, layer_idx=0, cache_k=ck[:, :2], cache_v=ck[:, :2], pos=0)
    with pytest.raises(IndexError, match="pos"):
        TDF.fused_qkv(*args, layer_idx=0, cache_k=ck, cache_v=ck.clone(), pos=T)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("pos", [0, 127, 200, T - 1])
def test_fused_attn_self(stacked, pos):
    rng = np.random.default_rng(1)
    li = 1 if stacked else None
    x, q = _rand(rng, B, D), _rand(rng, B, D)
    k = _layered(rng, stacked, B, T, D)
    v = _layered(rng, stacked, B, T, D)
    wo, bo = _layered(rng, stacked, D, D, scale=D ** -0.5), _layered(rng, stacked, D)
    ref = JDF.fused_attn(_j(x), _j(k), _j(v), _j(wo), _j(bo), q=_j(q),
                         pos=jnp.int32(pos), layer_idx=li)
    out = TDF.fused_attn(_t(x), _t(k), _t(v), _t(wo), _t(bo), q=_t(q),
                         pos=pos, layer_idx=li)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("stacked", [False, True])
def test_fused_attn_cross(stacked):
    s_valid = 300  # the padded tail 300..S must be ignored
    rng = np.random.default_rng(2)
    li = 0 if stacked else None
    x = _rand(rng, B, D, scale=1.0)
    lns = _layered(rng, stacked, D, scale=0.1, offset=1.0)
    lnb = _layered(rng, stacked, D, scale=0.1)
    wq, bq = _layered(rng, stacked, D, D, scale=D ** -0.5), _layered(rng, stacked, D)
    k = _layered(rng, stacked, B, S, D)
    v = _layered(rng, stacked, B, S, D)
    wo, bo = _layered(rng, stacked, D, D, scale=D ** -0.5), _layered(rng, stacked, D)
    ref = JDF.fused_attn(_j(x), _j(k), _j(v), _j(wo), _j(bo), s_valid=s_valid,
                         ln_scale=_j(lns), ln_bias=_j(lnb), wq=_j(wq),
                         bq=_j(bq), layer_idx=li)
    out = TDF.fused_attn(_t(x), _t(k), _t(v), _t(wo), _t(bo), s_valid=s_valid,
                         ln_scale=_t(lns), ln_bias=_t(lnb), wq=_t(wq),
                         bq=_t(bq), layer_idx=li)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("stacked", [False, True])
def test_fused_mlp(stacked):
    rng = np.random.default_rng(3)
    li = 2 if stacked else None
    x = _rand(rng, B, D, scale=1.0)
    lns = _layered(rng, stacked, D, scale=0.1, offset=1.0)
    lnb = _layered(rng, stacked, D, scale=0.1)
    w1, b1 = _layered(rng, stacked, D, FF, scale=D ** -0.5), _layered(rng, stacked, FF)
    w2, b2 = _layered(rng, stacked, FF, D, scale=FF ** -0.5), _layered(rng, stacked, D)
    args = (x, lns, lnb, w1, b1, w2, b2)
    ref = JDF.fused_mlp(*map(_j, args), layer_idx=li)
    out = TDF.fused_mlp(*map(_t, args), layer_idx=li)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("rows", [1, 16, 33])
def test_fused_mlp_rows(rows, weights):
    """fused_mlp at the row counts the card's tensor-core kernel serves in
    one pass (1, 16) and in two (33), stacked weights at layer 2, float or
    int8 fc1 and fc2 with their per-channel scales (the same numpy int8
    arrays on both sides)."""
    rng = np.random.default_rng(4 + rows)
    x = _rand(rng, rows, D, scale=1.0)
    lns = _layered(rng, True, D, scale=0.1, offset=1.0)
    lnb = _layered(rng, True, D, scale=0.1)
    w1, b1 = _layered(rng, True, D, FF, scale=D ** -0.5), _layered(rng, True, FF)
    w2, b2 = _layered(rng, True, FF, D, scale=FF ** -0.5), _layered(rng, True, D)
    scales = {}
    if weights == "int8":
        q1, q2 = (TQ.quantize_weight(torch.from_numpy(w)) for w in (w1, w2))
        w1, w2 = q1[TQ.QUANT_KEY].numpy(), q2[TQ.QUANT_KEY].numpy()
        scales = {"w1_scale": q1[TQ.SCALE_KEY].numpy(), "w2_scale": q2[TQ.SCALE_KEY].numpy()}
    args = (x, lns, lnb, w1, b1, w2, b2)
    ref = JDF.fused_mlp(*map(_j, args), layer_idx=2,
                        **{k: _j(v) for k, v in scales.items()})
    out = TDF.fused_mlp(*map(_t, args), layer_idx=2,
                        **{k: _t(v) for k, v in scales.items()})
    assert out.shape == (rows, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _int8_weight(w):
    """The same numpy int8 weight and (..., 1, N) fp32 scale for both sides."""
    q = TQ.quantize_weight(torch.from_numpy(w))
    return q[TQ.QUANT_KEY].numpy(), q[TQ.SCALE_KEY].numpy()


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("rows,G", [(1, 1), (16, 1), (33, 1), (16, 4), (24, 8)])
def test_fused_attn_rows(rows, G, weights, kv8):
    """Cross-attention at the row counts the card's tensor-core passes split
    on (1 and 16 rows in one pass, 33 in two; 16 rows at kv_group 4 and 24
    at kv_group 8, the JAX kernel's bound), stacked operands at layer 1,
    float or int8 wq and wo, float or int8 K/V with per-(row, head) scales
    (the same numpy arrays on both sides)."""
    rng = np.random.default_rng(10 * rows + G)
    Bk, s_valid = rows // G, 300
    x = _rand(rng, rows, D, scale=1.0)
    lns = _layered(rng, True, D, scale=0.1, offset=1.0)
    lnb = _layered(rng, True, D, scale=0.1)
    wq, bq = _layered(rng, True, D, D, scale=D ** -0.5), _layered(rng, True, D)
    wo, bo = _layered(rng, True, D, D, scale=D ** -0.5), _layered(rng, True, D)
    extra = {}
    if weights == "int8":
        (wq, extra["wq_scale"]), (wo, extra["wo_scale"]) = _int8_weight(wq), _int8_weight(wo)
    if kv8:
        k, v = (rng.integers(-127, 128, (L, Bk, S, D)).astype(np.int8) for _ in range(2))
        for name in ("k_scale", "v_scale"):
            extra[name] = np.repeat(np.exp(_rand(rng, L, Bk, D // 64)) / 127, 64,
                                    axis=-1).astype(np.float32)
    else:
        k, v = _layered(rng, True, Bk, S, D), _layered(rng, True, Bk, S, D)
    args = (x, k, v, wo, bo)
    kw = dict(ln_scale=lns, ln_bias=lnb, wq=wq, bq=bq, **extra)
    ref = JDF.fused_attn(*map(_j, args), s_valid=s_valid, layer_idx=1, kv_group=G,
                         **{n: _j(a) for n, a in kw.items()})
    out = TDF.fused_attn(*map(_t, args), s_valid=s_valid, layer_idx=1, kv_group=G,
                         **{n: _t(a) for n, a in kw.items()})
    assert out.shape == (rows, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("rows", [1, 16, 33])
def test_fused_attn_self_rows(rows, weights):
    """Self-attention at the row counts of the card's passes, pos 200 of a
    256 cache, stacked at layer 2, float or int8 wo."""
    rng = np.random.default_rng(rows)
    x, q = _rand(rng, rows, D), _rand(rng, rows, D)
    k, v = _layered(rng, True, rows, T, D), _layered(rng, True, rows, T, D)
    wo, bo = _layered(rng, True, D, D, scale=D ** -0.5), _layered(rng, True, D)
    extra = {}
    if weights == "int8":
        wo, extra["wo_scale"] = _int8_weight(wo)
    args = (x, k, v, wo, bo)
    ref = JDF.fused_attn(*map(_j, args), q=_j(q), pos=jnp.int32(200), layer_idx=2,
                         **{n: _j(a) for n, a in extra.items()})
    out = TDF.fused_attn(*map(_t, args), q=_t(q), pos=200, layer_idx=2,
                         **{n: _t(a) for n, a in extra.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _ln_f64_sums(x, scale, bias, eps=1e-5):
    """The bf16 kernels' LN prologue in numpy: the sums of x and of the fp32
    squares of (x - mean) in fp64, each rounded once to fp32 and times
    fp32(1/d); then ((x - mean) * rstd) * scale + bias, each step in fp32."""
    inv_d = np.float32(1.0 / x.shape[-1])
    mean = x.astype(np.float64).sum(-1, keepdims=True).astype(np.float32) * inv_d
    dv = x - mean
    var = (dv * dv).astype(np.float64).sum(-1, keepdims=True).astype(np.float32) * inv_d
    rstd = np.float32(1.0) / np.sqrt(var + np.float32(eps))
    return dv * rstd * scale + bias


@pytest.mark.parametrize("d", [256, 1280])
def test_ln_equals_the_fp64_sum_reference(d):
    """The plain versions' LN(x) is the kernels' arithmetic bit for bit, at
    a tiny width and at large-v3's."""
    rng = np.random.default_rng(d)
    x = _rand(rng, 64, d, scale=3.0, offset=0.5)
    lns, lnb = _rand(rng, d, scale=0.1, offset=1.0), _rand(rng, d, scale=0.1)
    out = TDF._ln(_t(x), _t(lns), _t(lnb)).numpy()
    np.testing.assert_array_equal(out, _ln_f64_sums(x, lns, lnb))


def test_ln_keeps_a_sum_that_fp32_rounds():
    """A row whose fp32 sum drops ones added to 2^24 (torch's fp32 mean, the
    former plain LN, rounds it otherwise than the fp64 sum): LN(x) follows
    the fp64 sum, as the kernels do, and differs from the fp32-mean LN."""
    x = np.ones((1, D), np.float32)
    x[0, 0] = 2.0 ** 24
    lns, lnb = np.ones(D, np.float32), np.zeros(D, np.float32)
    t = _t(x)
    fp32_mean = t.mean(dim=-1, keepdim=True)
    assert float(fp32_mean) != np.float32(x.astype(np.float64).sum()) * np.float32(1.0 / D)
    old = (t - fp32_mean) * torch.rsqrt(((t - fp32_mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    out = TDF._ln(t, _t(lns), _t(lnb)).numpy()
    np.testing.assert_array_equal(out, _ln_f64_sums(x, lns, lnb))
    assert not np.array_equal(out, old.numpy())


@pytest.mark.parametrize("rows,G,passes", [
    (1, 1, [1]), (16, 1, [16]), (20, 1, [20]), (32, 1, [32]), (33, 1, [32, 1]),
    (40, 1, [32, 8]), (16, 4, [16]), (24, 8, [24]), (40, 10, [30, 10]),
    (80, 40, [32, 8, 32, 8])])
def test_attn_passes(rows, G, passes):
    """bf16 fused_attn's passes on the card: whole groups of kv_group rows
    up to 32 rows, or 32 rows at a time of a wider group. G = 1 is also
    bf16 fused_attn_beam's at the beam path's rows: 4 x 4 (16), 2 x 10
    (20) and 4 x 10 (40: a pass need not hold whole utterances)."""
    assert TDF.attn_passes(rows, G) == passes


def test_pending_options_raise():
    """fused_attn's int8 KV (k_scale/v_scale) and shared beam cross-KV
    (kv_group) are ported (tests/test_torch_beam.py); what raises is a
    malformed request: one scale without the other, a group below 1 or not
    dividing the rows, k/v rows that do not match x's rows / kv_group. A
    group wider than the Pallas kernels' 8 is served."""
    x = torch.zeros(B, D)
    w = torch.zeros(D, D)
    b = torch.zeros(D)
    kv = torch.zeros(B, T, D)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        TDF.fused_attn(x, kv, kv, w, b, q=x, pos=0, k_scale=torch.ones(B, D))
    x9 = torch.zeros(9, D)
    assert TDF.fused_attn(x9, kv[:1], kv[:1], w, b, q=x9, pos=0, kv_group=9).shape == (9, D)
    with pytest.raises(ValueError, match="kv_group"):
        TDF.fused_attn(x, kv, kv, w, b, q=x, pos=0, kv_group=0)
    with pytest.raises(ValueError, match="kv_group"):
        TDF.fused_attn(x, kv, kv, w, b, q=x, pos=0, kv_group=2)
    with pytest.raises(ValueError, match="batch dim"):
        TDF.fused_attn(x, kv, kv, w, b, q=x, pos=0, kv_group=3)

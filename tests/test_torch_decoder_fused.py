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

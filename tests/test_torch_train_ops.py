"""Port parity for the training ops: the encoder-attention backward (plain
version, the CPU path of the CUDA kernel's autograd Function), the chunked
fused cross-entropy, the learning-rate schedules and AdamW with clipping,
each against the JAX package at fp32 on the CPU (Pallas in interpret mode,
optax for the optimizer). Inputs come from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_finetune_tpu.ops.encoder_attention import (
    dense_attention_packed as jax_dense_packed,
    encoder_attention as jax_encoder_attention)
from asr_finetune_tpu.ops.fused_ce import fused_cross_entropy as jax_fused_ce
from asr_finetune_tpu.training import optim as JO
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.ops import attention as TA
from asr_finetune_tpu_torch.ops import encoder_attention as TEA
from asr_finetune_tpu_torch.ops.fused_ce import fused_cross_entropy
from asr_finetune_tpu_torch.training import optim as TO

BWD_TOL = dict(rtol=1e-4, atol=1e-5)
HD = 64


def _packed(seed, B=2, Tq=150, Tk=150, H=2, scale=0.5):
    """q, k, v, do as packed (B, T, H*64) float32 arrays."""
    rng = np.random.default_rng(seed)
    shapes = [(B, Tq, H * HD), (B, Tk, H * HD), (B, Tk, H * HD), (B, Tq, H * HD)]
    return [(rng.standard_normal(s) * (scale if i < 3 else 1.0)).astype(np.float32)
            for i, s in enumerate(shapes)]


CASES = [  # (Tq, Tk, s_valid): self, cross, and keys masked past s_valid
    (150, 150, 150), (40, 150, 150), (150, 150, 97), (40, 150, 61)]


def _jax_vjp(q, k, v, do, s_valid):
    """Gradients of the JAX packed kernel (Pallas, interpret mode); with
    s_valid == Tk through the public encoder_attention on (B, T, H, hd)."""
    B, Tq, D = q.shape
    Tk, H = k.shape[1], D // HD
    if s_valid == Tk:
        def f(q_, k_, v_):
            return jax_encoder_attention(q_, k_, v_, interpret=True)
        args = [jnp.asarray(a.reshape(B, a.shape[1], H, HD)) for a in (q, k, v)]
        _, vjp = jax.vjp(f, *args)
        return [np.asarray(g).reshape(B, g.shape[1], D)
                for g in vjp(jnp.asarray(do.reshape(B, Tq, H, HD)))]
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_dense_packed(q_, k_, v_, HD, s_valid, True),
                     *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("Tq,Tk,s_valid", CASES)
def test_attention_bwd_plain_matches_jax_pallas(Tq, Tk, s_valid):
    q, k, v, do = _packed(Tq + s_valid, Tq=Tq, Tk=Tk)
    ref = _jax_vjp(q, k, v, do, s_valid)
    ours = TEA.dense_attention_packed_bwd_plain(
        *map(torch.from_numpy, (q, k, v, do)), HD, s_valid)
    for name, o, r in zip("qkv", ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), r, **BWD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("Tq,Tk,s_valid", CASES)
def test_attention_bwd_plain_matches_autograd(Tq, Tk, s_valid):
    """The plain backward against torch autograd of the plain forward, and
    the autograd Function (the training path) runs the plain backward on
    CPU tensors."""
    q, k, v, do = map(torch.from_numpy, _packed(7 * Tq + s_valid, Tq=Tq, Tk=Tk))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(TEA.dense_attention_packed_plain(*qkv, HD, s_valid),
                              qkv, do)
    ours = TEA.dense_attention_packed_bwd_plain(q, k, v, do, HD, s_valid)
    for name, o, r in zip("qkv", ours, ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), **BWD_TOL, err_msg=f"d{name}")
    fn = torch.autograd.grad(TEA.dense_attention_packed(*qkv, HD, s_valid), qkv, do)
    for o, r in zip(fn, ours):
        torch.testing.assert_close(o, r, rtol=0, atol=0)


def test_attention_bwd_plain_rounds_like_the_tpu_kernel():
    """bf16 inputs: ds and p are rounded to bf16 before their products and
    the outputs are bf16, as `_bwd_kernel_packed` casts them; the JAX
    kernel in interpret mode on the same bf16 inputs agrees to a bf16 step."""
    q, k, v, do = _packed(3, Tq=40, Tk=150)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    ours = TEA.dense_attention_packed_bwd_plain(tq, tk, tv, tdo, HD, 150)
    assert all(o.dtype == torch.bfloat16 for o in ours)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_dense_packed(q_, k_, v_, HD, 150, True),
                     *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (tq, tk, tv)))
    ref = vjp(jnp.asarray(tdo.float().numpy()).astype(jnp.bfloat16))
    for o, r in zip(ours, ref):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(o.float().numpy(), r, rtol=2 ** -7, atol=2e-3)


def test_attention_dispatch_impl():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, T, 2, HD)).astype(np.float32))
               for T in (30, 50, 50))
    torch.testing.assert_close(TA.attention(q, k, v, impl="xla"),
                               TA.xla_attention(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(TA.attention(q, k, v),
                               TEA.encoder_attention(q, k, v), rtol=0, atol=0)
    # causal calls stay plain whatever the impl
    torch.testing.assert_close(TA.attention(q, q, q, causal=True),
                               TA.xla_attention(q, q, q, causal=True), rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        TA.attention(q, k, v, impl="flash")


# ---------------------------------------------------------------------------
# fused chunked cross-entropy
# ---------------------------------------------------------------------------

def _ce_inputs(seed, B=3, T=37, d=32, V=71):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    e = (rng.standard_normal((V, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[:, -5:] = -100
    labels[1, :3] = -100
    return x, e, labels


@pytest.mark.parametrize("smoothing,embed_grad", [(0.0, True), (0.1, True),
                                                  (0.0, False)])
def test_fused_ce_matches_jax(smoothing, embed_grad):
    """Loss and (dx, dE) against the JAX fused CE, 64-row chunks over 111
    rows (a ragged last chunk)."""
    x, e, labels = _ce_inputs(int(smoothing * 10) + embed_grad)
    (jl, jn), vjp = jax.vjp(
        lambda x_, e_: jax_fused_ce(x_, e_, jnp.asarray(labels), smoothing, 64,
                                    embed_grad),
        jnp.asarray(x), jnp.asarray(e))
    jdx, jde = vjp((jnp.float32(1.0), jnp.int32(0)))
    tx = torch.from_numpy(x).requires_grad_(True)
    te = torch.from_numpy(e).requires_grad_(True)
    loss, n = fused_cross_entropy(tx, te, torch.from_numpy(labels), smoothing,
                                  64, embed_grad)
    loss.backward()
    assert int(n) == int(jn)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jde), atol=1e-5, rtol=1e-4)
    if not embed_grad:
        assert not te.grad.any()


def test_fused_ce_equals_cross_entropy_of_logits():
    x, e, labels = _ce_inputs(5)
    tx, te, tl = map(torch.from_numpy, (x, e, labels))
    for smoothing in (0.0, 0.2):
        loss, n = fused_cross_entropy(tx, te, tl, smoothing, chunk=16)
        ref, n_ref = TW.cross_entropy(torch.matmul(tx, te.t()), tl, smoothing)
        assert int(n) == int(n_ref)
        np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# schedules and AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["linear", "cosine", "constant"])
@pytest.mark.parametrize("warmup", [dict(warmup_steps=3), dict(warmup_ratio=0.25),
                                    dict()])
def test_lr_schedules_match_optax(scheduler, warmup):
    ref = JO.make_lr_schedule(2e-4, 20, scheduler, **warmup)
    ours = TO.make_lr_schedule(2e-4, 20, scheduler, **warmup)
    for c in range(24):
        np.testing.assert_allclose(ours(c), float(ref(c)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {c}")


@pytest.mark.parametrize("max_grad_norm", [1.0, 100.0])
def test_adamw_matches_optax(max_grad_norm):
    """Two updates on fixed gradients (clipped, and below the clip norm),
    weight decay on, warmup: the params after each against optax."""
    rng = np.random.default_rng(int(max_grad_norm))
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 2).astype(np.float32) for s in shapes]
             for _ in range(2)]
    kw = dict(scheduler="linear", warmup_steps=1, weight_decay=0.01,
              max_grad_norm=max_grad_norm)
    tx = JO.make_optimizer(1e-3, 10, **kw)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    opt = TO.make_optimizer(1e-3, 10, **kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step(tp, [torch.from_numpy(a.copy()) for a in g], ts)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            [jnp.asarray(a) for a in g])), rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)
    assert ts["count"] == 2

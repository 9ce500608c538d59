"""Port parity: asr_finetune_tpu_torch.ops.encoder_attention (plain version,
the CPU path of the CUDA kernel's wrapper) and ops.attention against the JAX
encoder attention in interpret mode and the XLA reference, at fp32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.ops.attention import xla_attention as jax_xla_attention
from asr_finetune_tpu.ops.encoder_attention import (
    dense_attention_packed as jax_dense_packed,
    encoder_attention as jax_encoder_attention)
from asr_finetune_tpu_torch.ops import attention as TA
from asr_finetune_tpu_torch.ops import encoder_attention as TEA

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, B=2, Tq=150, Tk=150, H=4, hd=64, scale=0.3):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((B, T, H, hd)) * scale).astype(np.float32)
                 for T in (Tq, Tk, Tk))


@pytest.mark.parametrize("Tq,Tk", [(150, 150), (200, 200), (40, 150), (130, 300)])
def test_encoder_attention_matches_jax(Tq, Tk):
    """Non-128 T (the kernel masks the ragged edge itself) and Tq != Tk."""
    q, k, v = _qkv(Tq + Tk, Tq=Tq, Tk=Tk)
    ref = jax_encoder_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    out = TEA.encoder_attention(*map(torch.from_numpy, (q, k, v)))
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("s_valid", [1, 97, 150])
def test_dense_attention_packed_s_valid(s_valid):
    """Keys at col >= s_valid are masked, as in the JAX packed kernel."""
    q, k, v = _qkv(s_valid, Tq=64, Tk=150)
    B, H, hd = 2, 4, 64
    pk = [a.reshape(B, a.shape[1], H * hd) for a in (q, k, v)]
    ref = jax_dense_packed(*map(jnp.asarray, pk), hd, s_valid, True)
    out = TEA.dense_attention_packed(*map(torch.from_numpy, pk), hd, s_valid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_dispatch_masked_and_causal_take_plain_softmax():
    q, k, v = _qkv(5, Tq=48, Tk=48)
    mask = np.random.default_rng(6).random((2, 1, 48, 48)) > 0.3
    mask[..., 0] = True
    for kw in (dict(mask=mask), dict(causal=True)):
        ref = jax_xla_attention(*map(jnp.asarray, (q, k, v)),
                                **{k_: jnp.asarray(v_) if k_ == "mask" else v_
                                   for k_, v_ in kw.items()})
        out = TA.attention(*map(torch.from_numpy, (q, k, v)),
                           **{k_: torch.from_numpy(v_) if k_ == "mask" else v_
                              for k_, v_ in kw.items()})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_dispatch_unmasked_runs_the_kernel_wrapper():
    q, k, v = map(torch.from_numpy, _qkv(7, Tq=70, Tk=90))
    np.testing.assert_array_equal(TA.attention(q, k, v).numpy(),
                                  TEA.encoder_attention(q, k, v).numpy())

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip without one (the
CPU suite runs the plain versions against JAX in the other test_torch_*
files). On a machine with the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

(--noconftest: tests/conftest.py imports jax, which that machine may lack.)

Small shapes (d=256, 4 heads of 64, B=3, 8 and 12: the GEMVs take rows in
groups of 8; the attention backward at B=3 and 8, self and cross shapes,
s_valid < Tk). Tolerance: fp32 1e-4 + 1e-4|ref| (the sum order differs from
the plain version's); bf16 4e-3 + 2^-7|ref| (both round the same
intermediates to bf16, so an output at a rounding boundary may land one
bf16 step, at most 2^-7 of its value, apart), as chip_smoke.py."""
import numpy as np
import pytest
import torch

from asr_finetune_tpu_torch.ops import decoder_fused as DF
from asr_finetune_tpu_torch.ops import encoder_attention as EA

pytestmark = pytest.mark.cuda

D, T, S, FF, L = 256, 256, 384, 512, 3
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (4e-3, 2.0 ** -7)}   # atol, rtol


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(out, ref, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               rtol=rtol, atol=atol)


def _rn(g, dev, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("B", [3, 8, 12])   # 4- and 8-row accumulators; 8 + 4
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_kernels_match_plain(dev, dtype, B):
    g = torch.Generator(device=dev).manual_seed(0)
    x = _rn(g, dev, B, D, dtype=dtype)
    lns, lnb = 1 + _rn(g, dev, L, D, scale=0.1), _rn(g, dev, L, D, scale=0.1)
    wq, wk, wv, wo = (_rn(g, dev, L, D, D, scale=D ** -0.5, dtype=dtype)
                      for _ in range(4))
    bq, bv, bo = (_rn(g, dev, L, D, scale=0.1, dtype=dtype) for _ in range(3))
    li = 2
    out = DF.fused_qkv(x, lns, lnb, wq, bq, wk, wv, bv, layer_idx=li)
    ref = DF.fused_qkv_plain(x, lns[li], lnb[li], wq[li], bq[li], wk[li], wv[li],
                             bv[li])
    for o, r in zip(out, ref):
        _close(o, r, dtype)

    q = _rn(g, dev, B, D, scale=0.125)
    k, v = _rn(g, dev, L, B, T, D, dtype=dtype), _rn(g, dev, L, B, T, D, dtype=dtype)
    for pos in (0, 100, T - 1):
        out = DF.fused_attn(x, k, v, wo, bo, q=q, pos=pos, layer_idx=li)
        _close(out, DF.fused_attn_plain(x, k[li], v[li], wo[li], bo[li], q=q,
                                        n_valid=pos + 1), dtype)
    kx, vx = _rn(g, dev, L, B, S, D, dtype=dtype), _rn(g, dev, L, B, S, D, dtype=dtype)
    out = DF.fused_attn(x, kx, vx, wo, bo, s_valid=300, ln_scale=lns, ln_bias=lnb,
                        wq=wq, bq=bq, layer_idx=li)
    _close(out, DF.fused_attn_plain(x, kx[li], vx[li], wo[li], bo[li], n_valid=300,
                                    ln_scale=lns[li], ln_bias=lnb[li], wq=wq[li],
                                    bq=bq[li]), dtype)

    w1, b1 = _rn(g, dev, L, D, FF, scale=D ** -0.5, dtype=dtype), _rn(g, dev, L, FF, dtype=dtype)
    w2, b2 = _rn(g, dev, L, FF, D, scale=FF ** -0.5, dtype=dtype), _rn(g, dev, L, D, dtype=dtype)
    out = DF.fused_mlp(x, lns, lnb, w1, b1, w2, b2, layer_idx=li)
    _close(out, DF.fused_mlp_plain(x, lns[li], lnb[li], w1[li], b1[li], w2[li],
                                   b2[li]), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,Tk,s_valid", [(150, 150, 150), (40, 300, 213)])
def test_encoder_attention_matches_plain(dev, dtype, Tq, Tk, s_valid):
    g = torch.Generator(device=dev).manual_seed(1)
    q = _rn(g, dev, 2, Tq, 4 * 64, dtype=dtype)
    k, v = (_rn(g, dev, 2, Tk, 4 * 64, dtype=dtype) for _ in range(2))
    out = EA.dense_attention_packed(q, k, v, 64, s_valid)
    _close(out, EA.dense_attention_packed_plain(q, k, v, 64, s_valid), dtype)


@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,Tk,s_valid", [(150, 150, 150), (40, 300, 213)])
def test_encoder_attention_bwd_matches_plain(dev, dtype, B, Tq, Tk, s_valid):
    """The autograd Function on the card: the forward kernel's lse against
    the plain logsumexp, its backward kernel's (dq, dk, dv) against the plain
    backward, and one launch of each kernel."""
    g = torch.Generator(device=dev).manual_seed(2)
    q = _rn(g, dev, B, Tq, 4 * 64, dtype=dtype).requires_grad_()
    k, v = (_rn(g, dev, B, Tk, 4 * 64, dtype=dtype).requires_grad_() for _ in range(2))
    do = _rn(g, dev, B, Tq, 4 * 64, dtype=dtype)
    _, lse = EA._dense_attention_packed_cuda(q.detach(), k.detach(), v.detach(), 64,
                                             s_valid, with_lse=True)
    np.testing.assert_allclose(
        lse.cpu().numpy(), EA.attention_lse_plain(q.detach(), k.detach(), 64,
                                                  s_valid).cpu().numpy(),
        rtol=1e-5, atol=1e-5)
    EA.reset_launches()
    out = EA.dense_attention_packed(q, k, v, 64, s_valid)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert EA.LAUNCHES == {"encoder_attention": 1, "encoder_attention_bwd": 1}
    ref = EA.dense_attention_packed_bwd_plain(q.detach(), k.detach(), v.detach(), do,
                                              64, s_valid)
    for gr, r in zip(grads, ref):
        assert gr.dtype == dtype
        _close(gr, r, dtype)
    for gr in grads[1:]:                     # masked keys get no gradient
        assert int(gr[:, s_valid:].count_nonzero()) == 0


def test_wrappers_reject_bad_operands(dev):
    B = 3
    x = torch.zeros(B, D, device=dev)
    w = torch.zeros(D, D, device=dev)
    b = torch.zeros(D, device=dev)
    with pytest.raises(ValueError):          # operand left on the CPU
        DF.fused_qkv(x, b.cpu(), b, w, b, w, w, b)
    with pytest.raises(TypeError):           # mixed dtypes
        DF.fused_qkv(x, b, b, w.bfloat16(), b, w, w, b)
    with pytest.raises(ValueError):          # x not contiguous
        DF.fused_mlp(torch.zeros(D, B, device=dev).t(), b, b, w, b, w, b)

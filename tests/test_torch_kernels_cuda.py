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
bf16 step, at most 2^-7 of its value, apart), as chip_smoke.py. The decoder
kernels run with int8 weights too (all-int8 and a merged-LoRA mix). The
W8A8 kernel is held to bit equality with its plain version, pure and with
the outlier keep-mask and addend, at ragged m, K and N, on both tiles; it
reads its weight from the K-major copy and raises without one. The beam
self-attention kernel runs at 2, 3, 8 and 10 beams over a random ancestry
map, the cross-attention's kv_group at 1, 3, 4, 8 and 10 with float and
int8 K/V. The encoder-attention kernels also run on the (BH, T, hd) and
fused-qkv layouts, and the log-mel kernel (fp32) at 80 and 128 mel bins."""
import numpy as np
import pytest
import torch

from asr_finetune_tpu_torch.ops import decoder_fused as DF
from asr_finetune_tpu_torch.ops import encoder_attention as EA
from asr_finetune_tpu_torch.ops import quant as Q
from asr_finetune_tpu_torch.ops import w8a8_fused as WF

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


@pytest.mark.parametrize("wo_int8", [False, True])
@pytest.mark.parametrize("K", [2, 3, 8, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attn_beam_matches_plain(dev, dtype, K, wo_int8):
    """Beam self-attention over an unpermuted (L, 2K, T, d) cache through a
    random ancestry map (stacked, layer 2), float or int8 wo; one launch
    counted per call under its name."""
    g = torch.Generator(device=dev).manual_seed(3)
    N = 2 * K
    x, q = _rn(g, dev, N, D, dtype=dtype), _rn(g, dev, N, D, scale=0.125)
    k, v = _rn(g, dev, L, N, T, D, dtype=dtype), _rn(g, dev, L, N, T, D, dtype=dtype)
    anc = torch.randint(0, K, (2, K, T), generator=g, device=dev, dtype=torch.int32)
    bo = _rn(g, dev, L, D, scale=0.1, dtype=dtype)
    w = _rn(g, dev, L, D, D, scale=D ** -0.5)
    if wo_int8:
        qw = Q.quantize_weight(w)
        wo, so = qw[Q.QUANT_KEY], qw[Q.SCALE_KEY]
    else:
        wo, so = w.to(dtype), None
    li = 2
    DF.reset_launches()
    for pos in (0, 100, 200, T - 1):
        out = DF.fused_attn_beam(x, k, v, wo, bo, q=q, pos=pos, ancestry=anc,
                                 wo_scale=so, layer_idx=li)
        _close(out, DF.fused_attn_beam_plain(x, k[li], v[li], wo[li], bo[li], q, pos, anc,
                                             None if so is None else so[li]), dtype)
    assert DF.LAUNCHES["fused_attn_beam" + ("_int8" if wo_int8 else "")] == 4


@pytest.mark.parametrize("G", [1, 3, 4, 8, 10])
@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attn_group_and_int8_kv_match_plain(dev, dtype, kv8, G):
    """Cross-attention of 2·G rows over 2 KV rows (kv_group G; the kernel's
    1-, 2-, 4- and 8-query blocks, and G = 10 as blocks of 8 and 2), float or int8 K/V with per-(row, head)
    scales, S 384, s_valid 300, stacked (layer 1)."""
    g = torch.Generator(device=dev).manual_seed(4)
    Bk, li = 2, 1
    x = _rn(g, dev, Bk * G, D, dtype=dtype)
    lns, lnb = 1 + _rn(g, dev, L, D, scale=0.1), _rn(g, dev, L, D, scale=0.1)
    wq, wo = (_rn(g, dev, L, D, D, scale=D ** -0.5, dtype=dtype) for _ in range(2))
    bq, bo = (_rn(g, dev, L, D, scale=0.1, dtype=dtype) for _ in range(2))
    if kv8:
        kx, vx = (torch.randint(-127, 128, (L, Bk, S, D), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.exp(_rn(g, dev, L, Bk, D // 64)).repeat_interleave(64, -1) / 127
                  for _ in range(2))
    else:
        kx, vx = (_rn(g, dev, L, Bk, S, D, dtype=dtype) for _ in range(2))
        ks = vs = None
    DF.reset_launches()
    DF.reset_kernel_launches()
    out = DF.fused_attn(x, kx, vx, wo, bo, s_valid=300, ln_scale=lns, ln_bias=lnb,
                        wq=wq, bq=bq, k_scale=ks, v_scale=vs, layer_idx=li, kv_group=G)
    # the q and wo GEMVs once per group of 8 rows, one partial, one combine
    groups = -(-Bk * G // 8)
    assert DF.kernel_launches() == {"gemv_kernel": 2 * groups, "attn_partial_kernel": 1,
                                    "attn_combine_kernel": 1}
    ref = DF.fused_attn_plain(x, kx[li], vx[li], wo[li], bo[li], n_valid=300,
                              ln_scale=lns[li], ln_bias=lnb[li], wq=wq[li], bq=bq[li],
                              k_scale=None if ks is None else ks[li],
                              v_scale=None if vs is None else vs[li], kv_group=G)
    _close(out, ref, dtype)
    name = DF.ATTN_CROSS[(G > 1) + 2 * kv8]
    assert DF.LAUNCHES[name] == 1 and sum(DF.LAUNCHES.values()) == 1


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
@pytest.mark.parametrize("Tq,Tk,s_valid", [(150, 150, 150), (40, 300, 213), (300, 150, 100)])
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
    assert {k: v for k, v in EA.LAUNCHES.items() if v} == {"encoder_attention": 1,
                                                           "encoder_attention_bwd": 1}
    ref = EA.dense_attention_packed_bwd_plain(q.detach(), k.detach(), v.detach(), do,
                                              64, s_valid)
    for gr, r in zip(grads, ref):
        assert gr.dtype == dtype
        _close(gr, r, dtype)
    for gr in grads[1:]:                     # masked keys get no gradient
        assert int(gr[:, s_valid:].count_nonzero()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,T_p,s_valid", [(12, 256, 150), (80, 128, 128), (32, 300, 213),
                                             (24, 40, 40)])
def test_dense_attention_bh_matches_plain(dev, dtype, BH, T_p, s_valid):
    """The (BH, T, hd) layout (B' = BH, one head, time stride 64): the
    forward and, through DenseAttention, the backward against the plain
    versions; zero-padded query rows give finite outputs, zero rows of dout
    and keys past s_valid add nothing to dk/dv; one launch of each under
    the layout's own counters."""
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (_rn(g, dev, BH, T_p, 64, dtype=dtype) for _ in range(3))
    for t in (q, k, v):
        t[:, s_valid:] = 0                    # the rows encoder_attention pads
    do = _rn(g, dev, BH, T_p, 64, dtype=dtype)
    do[:, s_valid:] = 0
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    EA.reset_launches()
    out = EA.dense_attention(q, k, v, s_valid)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert {k_: n for k_, n in EA.LAUNCHES.items() if n} == {
        "encoder_attention_bh": 1, "encoder_attention_bh_bwd": 1}
    out = out.detach()
    assert bool(out.isfinite().all())
    _close(out, EA.dense_attention_plain(q.detach(), k.detach(), v.detach(), s_valid), dtype)
    ref = EA.dense_attention_bwd_plain(q.detach(), k.detach(), v.detach(), do, s_valid)
    for gr, r in zip(grads, ref):
        _close(gr, r, dtype)
    for gr in grads[1:]:
        assert int(gr[:, s_valid:].count_nonzero()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H", [(2, 150, 4), (3, 300, 3), (8, 40, 2)])
def test_dense_attention_qkv_matches_plain(dev, dtype, B, T, H):
    """The fused-qkv layout: the kernels on the three column views of one
    (B, T, 3D) buffer (time stride 3D), the backward writing dq‖dk‖dv into
    one (B, T, 3D) gradient, against the plain versions; one launch of each
    under the layout's counters."""
    g = torch.Generator(device=dev).manual_seed(7)
    qkv = _rn(g, dev, B, T, 3 * H * 64, dtype=dtype).requires_grad_()
    do = _rn(g, dev, B, T, H * 64, dtype=dtype)
    EA.reset_launches()
    out = EA.dense_attention_qkv(qkv, 64)
    (grad,) = torch.autograd.grad(out, (qkv,), do)
    assert {k_: n for k_, n in EA.LAUNCHES.items() if n} == {
        "encoder_attention_qkv": 1, "encoder_attention_qkv_bwd": 1}
    assert grad.shape == qkv.shape and grad.is_contiguous()
    _close(out.detach(), EA.dense_attention_qkv_plain(qkv.detach(), 64), dtype)
    _close(grad, EA.dense_attention_qkv_bwd_plain(qkv.detach(), do, 64), dtype)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_plain(dev, n_mels):
    """The log-mel kernel (fp32, no TF32) against its plain version over 3
    utterances, one of them part silence: before the floor within 1e-4 +
    1e-4|ref| where the mel power is above the floor's reach, normalized
    within 1e-4."""
    from asr_finetune_tpu_torch.ops import logmel_fused as LF
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(8)
    audio = torch.randn((3, 480000), generator=g, device=dev) * 0.1
    audio[2, 100_000:300_000] = 0.0
    LF.reset_launches()
    raw = LF._log10_mel_cuda(audio, n_mels)
    assert LF.LAUNCHES["log_mel"] == 1
    ref = LF.log10_mel_plain(audio, n_mels)
    live = ref > ref.amax(dim=(1, 2), keepdim=True) - 8.0
    np.testing.assert_allclose(raw[live].cpu().numpy(), ref[live].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(LF.log_mel_fused(audio, n_mels).cpu().numpy(),
                               LF.log_mel_fused_plain(audio, n_mels).cpu().numpy(),
                               rtol=0, atol=1e-4)


def test_encoder_attention_bwd_rejects_misaligned_strides(dev):
    """The backward reads q/k/v/do by TMA: a time stride that is no
    multiple of 8 elements (16 bytes in bf16) or a base off 16 bytes
    raises before anything launches."""
    g = torch.Generator(device=dev).manual_seed(8)
    wide = _rn(g, dev, 2, 150, 4 * 64 + 4, dtype=torch.bfloat16)
    q = wide[..., :256]                                   # time stride 260
    k, v, do = (_rn(g, dev, 2, 150, 256, dtype=torch.bfloat16) for _ in range(3))
    lse = torch.zeros((2, 4, 150), device=dev)
    EA.reset_launches()
    with pytest.raises(ValueError, match="multiples of 8"):
        EA._dense_attention_packed_bwd_cuda(q, k, v, do, lse, 64, 150)
    off = _rn(g, dev, 2 * 150 * 256 + 4, dtype=torch.bfloat16)[4:].view(2, 150, 256)
    with pytest.raises(ValueError, match="16-byte"):
        EA._dense_attention_packed_bwd_cuda(off, k, v, do, lse, 64, 150)
    assert not any(EA.LAUNCHES.values())


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


def _int8(w):
    q = Q.quantize_weight(w)
    return q["w_q8"], q["w_scale"]


@pytest.mark.parametrize("mix", ["int8", "mixed"])
@pytest.mark.parametrize("B", [3, 8, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_kernels_int8_weights_match_plain(dev, dtype, B, mix):
    """The int8-weight option of the GEMV in fused_qkv, fused_attn (self and
    cross) and fused_mlp: every projection int8 ("int8"), or q/v and fc2
    float beside int8 k/o/fc1 ("mixed", a merged-LoRA base), layer 2 of 3."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = _rn(g, dev, B, D, dtype=dtype)
    lns, lnb = 1 + _rn(g, dev, L, D, scale=0.1), _rn(g, dev, L, D, scale=0.1)
    w = {n: _int8(_rn(g, dev, L, D, D, scale=D ** -0.5)) for n in "qkvo"}
    w["fc1"] = _int8(_rn(g, dev, L, D, FF, scale=D ** -0.5))
    w["fc2"] = _int8(_rn(g, dev, L, FF, D, scale=FF ** -0.5))
    floats = {"q", "v", "fc2"} if mix == "mixed" else set()
    wt = {n: ((q8.float() * s).to(dtype), None) if n in floats else (q8, s)
          for n, (q8, s) in w.items()}
    bq, bv, bo = (_rn(g, dev, L, D, scale=0.1, dtype=dtype) for _ in range(3))
    b1 = _rn(g, dev, L, FF, dtype=dtype)
    li = 2
    at = lambda n: (wt[n][0][li], None if wt[n][1] is None else wt[n][1][li])  # noqa: E731
    out = DF.fused_qkv(x, lns, lnb, wt["q"][0], bq, wt["k"][0], wt["v"][0], bv,
                       wq_scale=wt["q"][1], wk_scale=wt["k"][1], wv_scale=wt["v"][1],
                       layer_idx=li)
    ref = DF.fused_qkv_plain(x, lns[li], lnb[li], at("q")[0], bq[li], at("k")[0],
                             at("v")[0], bv[li], wq_scale=at("q")[1],
                             wk_scale=at("k")[1], wv_scale=at("v")[1])
    for o, r in zip(out, ref):
        _close(o, r, dtype)
    q = _rn(g, dev, B, D, scale=0.125)
    k, v = _rn(g, dev, L, B, T, D, dtype=dtype), _rn(g, dev, L, B, T, D, dtype=dtype)
    out = DF.fused_attn(x, k, v, wt["o"][0], bo, q=q, pos=100, wo_scale=wt["o"][1],
                        layer_idx=li)
    _close(out, DF.fused_attn_plain(x, k[li], v[li], at("o")[0], bo[li], q=q,
                                    n_valid=101, wo_scale=at("o")[1]), dtype)
    out = DF.fused_attn(x, k, v, wt["o"][0], bo, s_valid=200, ln_scale=lns, ln_bias=lnb,
                        wq=wt["q"][0], bq=bq, wq_scale=wt["q"][1], wo_scale=wt["o"][1],
                        layer_idx=li)
    _close(out, DF.fused_attn_plain(x, k[li], v[li], at("o")[0], bo[li], n_valid=200,
                                    ln_scale=lns[li], ln_bias=lnb[li], wq=at("q")[0],
                                    bq=bq[li], wq_scale=at("q")[1],
                                    wo_scale=at("o")[1]), dtype)
    out = DF.fused_mlp(x, lns, lnb, wt["fc1"][0], b1, wt["fc2"][0], bo,
                       w1_scale=wt["fc1"][1], w2_scale=wt["fc2"][1], layer_idx=li)
    _close(out, DF.fused_mlp_plain(x, lns[li], lnb[li], at("fc1")[0], b1[li],
                                   at("fc2")[0], bo[li], w1_scale=at("fc1")[1],
                                   w2_scale=at("fc2")[1]), dtype)


# m, K, N of each W8A8 case, and whether it runs the wide tile
W8A8_CASES = {
    "B3": (111, 4112, 208, False),
    "B8": (296, 4112, 208, False),
    "B12": (444, 4112, 208, False),
    "one pass": (2000, 1008, 2200, True),
    "K 5120": (300, 5120, 3840, False),
    "wide ragged": (1000, 1280, 2056, True),
}


@pytest.mark.parametrize("outliers", [False, True])
@pytest.mark.parametrize("shape", list(W8A8_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_matches_plain_bitwise(dev, dtype, shape, outliers):
    """The W8A8 kernel equals w8a8_plain bit for bit. At B = 3, 8 and 12:
    m = 37·B rows (no multiple of 64: a ragged last tile, zero-filled by
    TMA on the way in and clipped on the way out), K = 4112 (a ragged last
    128-deep slice) and N = 208 (a ragged last 128-column tile) on the
    narrow 64 x 128 tile; "K 5120": the decoder fc2's depth at m 300 and N
    3840; "one pass" (m 2000, N 2200) and "wide ragged" (m 1000, N 2056)
    on the wide 128 x 256 tile with ragged edges. With outliers, the
    keep-mask and addend of the dynamic top-4 form; one launch per call.
    The weight is read from its K-major copy."""
    m, K, N, wide = W8A8_CASES[shape]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert WF.wide_for(m, N, sms) == wide
    g = torch.Generator(device=dev).manual_seed(m)
    x = _rn(g, dev, m, K, dtype=dtype)
    x[:, 7] *= 50.0
    w8, ws = _int8(_rn(g, dev, K, N, scale=0.05))
    keep = addend = None
    if outliers:
        keep, addend = Q._outlier_split(x, w8, ws, Q.QuantConfig(matmul=True,
                                                                 outlier_cols=4))
    WF.reset_launches()
    out = WF.w8a8(x, w8, ws, keep, addend, w8.t().contiguous())
    assert WF.LAUNCHES["w8a8"] == 1 and out.dtype == dtype and out.shape == (m, N)
    ref = WF.w8a8_plain(x, w8, ws, keep, addend)
    assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())


def test_w8a8_rejects_a_missing_or_mismatched_copy(dev):
    """On the card the wrapper raises, and launches nothing, without the
    K-major copy, with one of another shape, dtype or device, at a K that
    is no multiple of 16 or an N no multiple of 8 (TMA's row pitches), and
    at a K beyond the quantize pass's 8192; it never transposes."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = _rn(g, dev, 64, 256)
    w8, ws = _int8(_rn(g, dev, 256, 128, scale=0.05))
    WF.reset_launches()
    for bad in (None, w8, w8.t().contiguous().cpu(), w8.t().contiguous().float(),
                w8.t().contiguous()[:, :128]):
        with pytest.raises(ValueError):
            WF.w8a8(x, w8, ws, w_nk=bad)
    x2 = _rn(g, dev, 64, 264)
    w2, s2 = _int8(_rn(g, dev, 264, 128, scale=0.05))
    with pytest.raises(ValueError, match="K % 16"):
        WF.w8a8(x2, w2, s2, w_nk=w2.t().contiguous())
    w3, s3 = _int8(_rn(g, dev, 256, 124, scale=0.05))
    with pytest.raises(ValueError, match="N % 8"):
        WF.w8a8(x, w3, s3, w_nk=w3.t().contiguous())
    x4 = _rn(g, dev, 8, 8208)
    w4, s4 = _int8(_rn(g, dev, 8208, 8, scale=0.05))
    with pytest.raises(ValueError, match="8192"):
        WF.w8a8(x4, w4, s4, w_nk=w4.t().contiguous())
    assert WF.LAUNCHES["w8a8"] == 0


def test_int8_matmul_grad_on_the_card(dev):
    """The autograd Function on the card: the forward through the kernel,
    the straight-through backward dy @ W_deqᵀ."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = _rn(g, dev, 64, 256).requires_grad_()
    w8, ws = _int8(_rn(g, dev, 256, 128, scale=0.05))
    dy = _rn(g, dev, 64, 128)
    WF.reset_launches()
    y = Q.int8_matmul(x, w8, ws, Q.QuantConfig(matmul=True), w8.t().contiguous())
    (y * dy).sum().backward()
    assert WF.LAUNCHES["w8a8"] == 1
    assert torch.equal(y, WF.w8a8_plain(x.detach(), w8, ws))
    _close(x.grad, dy @ (w8.float() * ws).t(), torch.float32)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip without one (the
CPU suite runs the plain versions against JAX in the other test_torch_*
files). On a machine with the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

(--noconftest: tests/conftest.py imports jax, which that machine may lack.)

Small shapes (d=256, 4 heads of 64, B=3, 8 and 12: the GEMVs take rows in
groups of 8; the bf16 MLP on the tensor cores at 1 to 33 rows, in passes of
8, 16 and 32 rows, and (d, ff) = (256, 512) and (384, 1536), bit-equal
twice; the attention forward and backward at B=3 and 8, self and cross
shapes, s_valid < Tk; the forward also at 20 heads). Tolerance: fp32 1e-4 +
1e-4|ref| (the sum order differs from the plain version's); bf16 4e-3 +
2^-7|ref| (both round the same intermediates to bf16, so an output at a
rounding boundary may land one bf16 step, at most 2^-7 of its value, apart),
as chip_smoke.py. The decoder kernels run with int8 weights too (all-int8
and a merged-LoRA mix). The W8A8 kernel is held to bit equality with its
plain version, pure and with the outlier keep-mask and addend, at ragged m,
K and N, on both tiles, also with the row amax supplied (tensor
parallelism); it reads its weight from the K-major copy and raises
without one. The beam self-attention kernel runs at 2, 3, 8 and 10 beams
over a random ancestry map (bf16: the attention core gathering each key row
through it, then wo, once per pass of up to 32 rows, bit-equal twice, no
GEMV), the cross-attention's kv_group at 1, 3, 4, 8 and
10 with float and int8 K/V. The bf16 fused_attn (tensor-core q and wo, the
attention core) runs at 1 to 40 rows (passes of up to 32), kv_group 1, 4, 8
and 10 over float, mixed and int8 weights and K/V, self at pos 0 to T-1 and
cross at s_valid 1 to 1500 over S 1536, two calls bit-equal, its launches
counted per pass. The bf16 fused_qkv (one tensor-core launch a pass of up to
32 rows) runs at 1 to 33 rows over float, int8 and mixed q/k/v, two calls
bit-equal, and writes k and v into a self cache's row pos and nowhere else.
The encoder-attention kernels also run on the
(BH, T, hd) and fused-qkv layouts, and the log-mel kernel (fp32) at 80 and
128 mel bins, its floor bit-equal to the plain floor of its raw output and
two replays of a captured call bit-equal to an eager call."""
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
    if dtype == torch.float32:
        # the q and wo GEMVs once per group of 8 rows, one partial, one combine
        want = {"gemv_kernel": 2 * -(-Bk * G // 8), "attn_partial_kernel": 1,
                "attn_combine_kernel": 1}
    else:
        # the q product, the attention core and wo once per pass of <= 32 rows
        passes = len(DF.attn_passes(Bk * G, G))
        want = {"attn_q_kernel": passes, "attn_chunk_kernel": passes,
                "attn_wo_kernel": passes}
    assert DF.kernel_launches() == {**dict.fromkeys(DF.KERNELS, 0), **want}
    ref = DF.fused_attn_plain(x, kx[li], vx[li], wo[li], bo[li], n_valid=300,
                              ln_scale=lns[li], ln_bias=lnb[li], wq=wq[li], bq=bq[li],
                              k_scale=None if ks is None else ks[li],
                              v_scale=None if vs is None else vs[li], kv_group=G)
    _close(out, ref, dtype)
    name = DF.ATTN_CROSS[(G > 1) + 2 * kv8]
    assert DF.LAUNCHES[name] == 1 and sum(DF.LAUNCHES.values()) == 1


def _attn_weights(g, dev, weights):
    """Stacked (L, D, D) wq and wo with their int8 scales (None for a float
    one): "float", "mixed" (a merged-LoRA base: q float, o int8) or "int8"."""
    out = []
    for name in ("q", "o"):
        w = _rn(g, dev, L, D, D, scale=D ** -0.5)
        int8 = weights == "int8" or (weights == "mixed" and name == "o")
        out.append(_int8(w) if int8 else (w.bfloat16(), None))
    return out


def _at_layer(t, li):
    return None if t is None else t[li]


def _check_tc_attn(call, plain, passes, kernels, launches_per_pass):
    """One bf16 fused_attn call on the tensor-core route: held against its
    plain version, bit-equal to a second call, and `launches_per_pass` of
    `kernels` each pass, nothing else launched."""
    DF.reset_kernel_launches()
    out = call()
    assert DF.kernel_launches() == {**dict.fromkeys(DF.KERNELS, 0),
                                    **dict.fromkeys(kernels, passes)}
    assert len(kernels) == launches_per_pass
    _close(out, plain(), torch.bfloat16)
    assert torch.equal(out, call())


@pytest.mark.parametrize("weights", ["float", "mixed", "int8"])
@pytest.mark.parametrize("B", [1, 4, 8, 9, 16, 32, 33, 40])
def test_fused_attn_tc_matches_plain(dev, B, weights):
    """bf16 fused_attn on the tensor cores at 1 to 40 rows (33 and 40: two
    passes of up to 32), wq/wo float, mixed or int8, stacked at layer 2 of
    3: self-attention at pos 0, 127, 200 and T-1 (2 launches a pass: the
    core, wo with the combine) and cross-attention over S 384, s_valid 300
    (3: q, the core, wo); two calls bit-equal, no GEMV, no combine."""
    g = torch.Generator(device=dev).manual_seed(100 + B)
    bf, li = torch.bfloat16, 2
    x = _rn(g, dev, B, D, dtype=bf)
    lns, lnb = 1 + _rn(g, dev, L, D, scale=0.1), _rn(g, dev, L, D, scale=0.1)
    (wq, sq), (wo, so) = _attn_weights(g, dev, weights)
    bq, bo = (_rn(g, dev, L, D, scale=0.1, dtype=bf) for _ in range(2))
    passes = len(DF.attn_passes(B))
    q = _rn(g, dev, B, D, scale=0.125)
    k, v = _rn(g, dev, L, B, T, D, dtype=bf), _rn(g, dev, L, B, T, D, dtype=bf)
    for pos in (0, 127, 200, T - 1):
        _check_tc_attn(
            lambda: DF.fused_attn(x, k, v, wo, bo, q=q, pos=pos, wo_scale=so, layer_idx=li),
            lambda: DF.fused_attn_plain(x, k[li], v[li], wo[li], bo[li], q=q, n_valid=pos + 1,
                                        wo_scale=_at_layer(so, li)),
            passes, ("attn_chunk_kernel", "attn_wo_kernel"), 2)
    kx, vx = _rn(g, dev, L, B, S, D, dtype=bf), _rn(g, dev, L, B, S, D, dtype=bf)
    _check_tc_attn(
        lambda: DF.fused_attn(x, kx, vx, wo, bo, s_valid=300, ln_scale=lns, ln_bias=lnb,
                              wq=wq, bq=bq, wq_scale=sq, wo_scale=so, layer_idx=li),
        lambda: DF.fused_attn_plain(x, kx[li], vx[li], wo[li], bo[li], n_valid=300,
                                    ln_scale=lns[li], ln_bias=lnb[li], wq=wq[li], bq=bq[li],
                                    wq_scale=_at_layer(sq, li), wo_scale=_at_layer(so, li)),
        passes, ("attn_q_kernel", "attn_chunk_kernel", "attn_wo_kernel"), 3)


@pytest.mark.parametrize("weights", ["float", "mixed", "int8"])
@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("G", [1, 4, 8, 10])
def test_fused_attn_tc_groups_match_plain(dev, G, kv8, weights):
    """bf16 cross-attention of 4·G rows over 4 KV rows (kv_group G; G = 10:
    passes of 30 and 10 rows), float or int8 K/V with per-(row, head)
    scales, every kind of wq/wo, S 384, s_valid 300, stacked (layer 1)."""
    g = torch.Generator(device=dev).manual_seed(200 + G)
    bf, Bk, li = torch.bfloat16, 4, 1
    x = _rn(g, dev, Bk * G, D, dtype=bf)
    lns, lnb = 1 + _rn(g, dev, L, D, scale=0.1), _rn(g, dev, L, D, scale=0.1)
    (wq, sq), (wo, so) = _attn_weights(g, dev, weights)
    bq, bo = (_rn(g, dev, L, D, scale=0.1, dtype=bf) for _ in range(2))
    if kv8:
        kx, vx = (torch.randint(-127, 128, (L, Bk, S, D), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.exp(_rn(g, dev, L, Bk, D // 64)).repeat_interleave(64, -1) / 127
                  for _ in range(2))
    else:
        kx, vx = (_rn(g, dev, L, Bk, S, D, dtype=bf) for _ in range(2))
        ks = vs = None
    _check_tc_attn(
        lambda: DF.fused_attn(x, kx, vx, wo, bo, s_valid=300, ln_scale=lns, ln_bias=lnb,
                              wq=wq, bq=bq, k_scale=ks, v_scale=vs, wq_scale=sq, wo_scale=so,
                              layer_idx=li, kv_group=G),
        lambda: DF.fused_attn_plain(x, kx[li], vx[li], wo[li], bo[li], n_valid=300,
                                    ln_scale=lns[li], ln_bias=lnb[li], wq=wq[li], bq=bq[li],
                                    wq_scale=_at_layer(sq, li), wo_scale=_at_layer(so, li),
                                    k_scale=_at_layer(ks, li), v_scale=_at_layer(vs, li),
                                    kv_group=G),
        len(DF.attn_passes(Bk * G, G)), ("attn_q_kernel", "attn_chunk_kernel", "attn_wo_kernel"),
        3)


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("s_valid", [1, 255, 256, 257, 1500])
def test_fused_attn_tc_cross_lengths(dev, s_valid, kv8):
    """bf16 cross-attention over the decoder's padded source, S 1536, at
    valid lengths on and around a chunk's edge, float or int8 K/V, 4 rows."""
    g = torch.Generator(device=dev).manual_seed(s_valid)
    bf, B, Sp = torch.bfloat16, 4, 1536
    x = _rn(g, dev, B, D, dtype=bf)
    lns, lnb = 1 + _rn(g, dev, D, scale=0.1), _rn(g, dev, D, scale=0.1)
    (wq, _), (wo, _) = _attn_weights(g, dev, "float")
    wq, wo = wq[0], wo[0]
    bq, bo = (_rn(g, dev, D, scale=0.1, dtype=bf) for _ in range(2))
    if kv8:
        kx, vx = (torch.randint(-127, 128, (B, Sp, D), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.exp(_rn(g, dev, B, D // 64)).repeat_interleave(64, -1) / 127
                  for _ in range(2))
    else:
        kx, vx = (_rn(g, dev, B, Sp, D, dtype=bf) for _ in range(2))
        ks = vs = None
    _check_tc_attn(
        lambda: DF.fused_attn(x, kx, vx, wo, bo, s_valid=s_valid, ln_scale=lns, ln_bias=lnb,
                              wq=wq, bq=bq, k_scale=ks, v_scale=vs),
        lambda: DF.fused_attn_plain(x, kx, vx, wo, bo, n_valid=s_valid, ln_scale=lns,
                                    ln_bias=lnb, wq=wq, bq=bq, k_scale=ks, v_scale=vs),
        1, ("attn_q_kernel", "attn_chunk_kernel", "attn_wo_kernel"), 3)


@pytest.mark.parametrize("K", [4, 10])   # 4 x 4 rows: one pass; 4 x 10: passes of 32 and 8
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attn_beam_keeps_its_kernels(dev, dtype, K):
    """bf16 fused_attn_beam runs the attention core in beam mode and the wo
    product once per pass of attn_passes (16 rows: 1 + 1; 40 rows: 2 + 2),
    no GEMV, partial or combine, two calls bit-equal; fp32 keeps the GEMV
    route: its partial, its combine and the wo GEMV once per group of 8
    rows."""
    g = torch.Generator(device=dev).manual_seed(5)
    N = 4 * K
    x, q = _rn(g, dev, N, D, dtype=dtype), _rn(g, dev, N, D, scale=0.125)
    k, v = _rn(g, dev, N, T, D, dtype=dtype), _rn(g, dev, N, T, D, dtype=dtype)
    anc = torch.randint(0, K, (4, K, T), generator=g, device=dev, dtype=torch.int32)
    wo, bo = _rn(g, dev, D, D, scale=D ** -0.5, dtype=dtype), _rn(g, dev, D, dtype=dtype)
    DF.reset_kernel_launches()
    out = DF.fused_attn_beam(x, k, v, wo, bo, q=q, pos=100, ancestry=anc)
    if dtype == torch.bfloat16:
        passes = len(DF.attn_passes(N))
        want = {"attn_chunk_kernel": passes, "attn_wo_kernel": passes}
    else:
        want = {"gemv_kernel": -(-N // 8), "attn_partial_kernel": 1, "attn_combine_kernel": 1}
    assert DF.kernel_launches() == {**dict.fromkeys(DF.KERNELS, 0), **want}
    _close(out, DF.fused_attn_beam_plain(x, k, v, wo, bo, q, 100, anc), dtype)
    if dtype == torch.bfloat16:
        assert torch.equal(out, DF.fused_attn_beam(x, k, v, wo, bo, q=q, pos=100, ancestry=anc))


@pytest.mark.parametrize("pos", [255, 256, 300, 447])
def test_fused_attn_beam_tc_long_cache(dev, pos):
    """bf16 fused_attn_beam over Whisper's longest cache (448): two chunks
    of 256 keys past pos 255, combined by the last chunk's block; 4 x 4
    rows, stacked at layer 1, bit-equal twice."""
    g = torch.Generator(device=dev).manual_seed(pos)
    bf, K, N, T_long, li = torch.bfloat16, 4, 16, 448, 1
    x, q = _rn(g, dev, N, D, dtype=bf), _rn(g, dev, N, D, scale=0.125)
    k, v = (_rn(g, dev, L, N, T_long, D, dtype=bf) for _ in range(2))
    anc = torch.randint(0, K, (4, K, T_long), generator=g, device=dev, dtype=torch.int32)
    wo, bo = _rn(g, dev, L, D, D, scale=D ** -0.5, dtype=bf), _rn(g, dev, L, D, dtype=bf)

    def call():
        return DF.fused_attn_beam(x, k, v, wo, bo, q=q, pos=pos, ancestry=anc, layer_idx=li)
    out = call()
    _close(out, DF.fused_attn_beam_plain(x, k[li], v[li], wo[li], bo[li], q, pos, anc), bf)
    assert torch.equal(out, call())


# the forward's (Tq, Tk, s_valid): self and cross as before, then every Tq
# of {40, 150, 192, 300, 448} against every Tk of {150, 300, 1500} with
# s_valid < Tk (ragged tiles on both axes)
FWD_CASES = [(150, 150, 150), (40, 300, 213)] + [
    (tq, tk, tk * 5 // 7) for tq in (40, 150, 192, 300, 448) for tk in (150, 300, 1500)]


@pytest.mark.parametrize("H", [4, 20])
@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,Tk,s_valid", FWD_CASES)
def test_encoder_attention_matches_plain(dev, dtype, Tq, Tk, s_valid, B, H):
    """The forward kernel against its plain version; its lse against the
    plain logsumexp (rtol = atol = 1e-5); two calls give the same bits (no
    atomics); one launch a call. At 20 heads and B 8 the bf16 kernel runs
    blocks of 128 queries (two warpgroups) from Tq 150 on, elsewhere blocks
    of 64 (one): it takes two while that still fills two blocks an SM."""
    g = torch.Generator(device=dev).manual_seed(1)
    q = _rn(g, dev, B, Tq, H * 64, dtype=dtype)
    k, v = (_rn(g, dev, B, Tk, H * 64, dtype=dtype) for _ in range(2))
    EA.reset_launches()
    out = EA.dense_attention_packed(q, k, v, 64, s_valid)
    assert EA.LAUNCHES["encoder_attention"] == 1
    _close(out, EA.dense_attention_packed_plain(q, k, v, 64, s_valid), dtype)
    again, lse = EA._dense_attention_packed_cuda(q, k, v, 64, s_valid, with_lse=True)
    assert torch.equal(again, out)
    np.testing.assert_allclose(lse.cpu().numpy(),
                               EA.attention_lse_plain(q, k, 64, s_valid).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    _, lse2 = EA._dense_attention_packed_cuda(q, k, v, 64, s_valid, with_lse=True)
    assert torch.equal(lse2, lse)


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


@pytest.mark.parametrize("n_mels", [1, 80, 128])
def test_log_mel_graph_replay(dev, n_mels):
    """The floor's per-utterance max and tickets come back to their idle
    values inside each call: two replays of a captured call give the same
    bits as each other and as an eager call, and the floor equals
    _normalize of the kernel's raw output bit for bit."""
    from asr_finetune_tpu_torch.ops import logmel_fused as LF
    g = torch.Generator(device=dev).manual_seed(9)
    audio = torch.randn((2, 480000), generator=g, device=dev) * 0.1
    audio[1, :150_000] = 0.0
    eager = LF.log_mel_fused(audio, n_mels)
    assert torch.equal(eager, LF._normalize(LF._log10_mel_cuda(audio, n_mels)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        LF.log_mel_fused(audio, n_mels)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = LF.log_mel_fused(audio, n_mels)
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, out) and torch.equal(out, eager)
    assert torch.equal(LF.log_mel_fused(audio, n_mels), eager)


@pytest.mark.parametrize("fault", ["time stride", "base"])
@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_encoder_attention_fwd_rejects_misaligned_strides(dev, operand, fault):
    """The bf16 forward reads q/k/v (and writes out) by TMA: an operand whose
    time stride is no multiple of 8 elements (16 bytes) or whose base is off
    16 bytes raises before anything launches."""
    g = torch.Generator(device=dev).manual_seed(8)
    ops = {n: _rn(g, dev, 2, 150, 256, dtype=torch.bfloat16) for n in "qkv"}
    if fault == "time stride":
        ops[operand] = _rn(g, dev, 2, 150, 4 * 64 + 4, dtype=torch.bfloat16)[..., :256]
        match = "multiples of 8"
    else:
        ops[operand] = _rn(g, dev, 2 * 150 * 256 + 4,
                           dtype=torch.bfloat16)[4:].view(2, 150, 256)
        match = "16-byte"
    EA.reset_launches()
    with pytest.raises(ValueError, match=match):
        EA.dense_attention_packed(ops["q"], ops["k"], ops["v"], 64, 150)
    assert not any(EA.LAUNCHES.values())


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


@pytest.mark.parametrize("d,ff", [(256, 512), (384, 1536)])
@pytest.mark.parametrize("weights", ["float", "int8", "mixed"])
@pytest.mark.parametrize("B", [1, 3, 4, 8, 12, 16, 17, 32, 33])
def test_fused_mlp_matches_plain(dev, B, weights, d, ff):
    """The bf16 fused_mlp on the tensor cores: 8-, 16- and 32-row passes
    (33 rows: two passes), fc1/fc2 float, both int8 or fc1 int8 beside a
    float fc2, stacked weights read at layer 2 of 3; two calls give the same
    bits, and each pass is one fc1 and one fc2 launch, no GEMV."""
    g = torch.Generator(device=dev).manual_seed(B)
    x = _rn(g, dev, B, d, dtype=torch.bfloat16)
    lns, lnb = 1 + _rn(g, dev, L, d, scale=0.1), _rn(g, dev, L, d, scale=0.1)
    w1 = _rn(g, dev, L, d, ff, scale=d ** -0.5)
    w2 = _rn(g, dev, L, ff, d, scale=ff ** -0.5)
    b1 = _rn(g, dev, L, ff, scale=0.1, dtype=torch.bfloat16)
    b2 = _rn(g, dev, L, d, scale=0.1, dtype=torch.bfloat16)
    int8 = {"float": (), "int8": ("fc1", "fc2"), "mixed": ("fc1",)}[weights]
    (w1, s1), (w2, s2) = ((_int8(w) if n in int8 else (w.bfloat16(), None))
                          for n, w in (("fc1", w1), ("fc2", w2)))
    li = 2
    DF.reset_kernel_launches()
    out = DF.fused_mlp(x, lns, lnb, w1, b1, w2, b2, w1_scale=s1, w2_scale=s2, layer_idx=li)
    passes = -(-B // 32)
    assert DF.kernel_launches() == {**dict.fromkeys(DF.KERNELS, 0), "mlp_fc1_kernel": passes,
                                    "mlp_fc2_kernel": passes}
    ref = DF.fused_mlp_plain(x, lns[li], lnb[li], w1[li], b1[li], w2[li], b2[li],
                             w1_scale=None if s1 is None else s1[li],
                             w2_scale=None if s2 is None else s2[li])
    _close(out, ref, torch.bfloat16)
    again = DF.fused_mlp(x, lns, lnb, w1, b1, w2, b2, w1_scale=s1, w2_scale=s2,
                         layer_idx=li)
    assert torch.equal(out, again)


@pytest.mark.parametrize("weights", ["float", "int8", "mixed"])
@pytest.mark.parametrize("B", [1, 4, 12, 16, 32, 33])
def test_fused_qkv_tc_matches_plain(dev, B, weights):
    """bf16 fused_qkv on the tensor cores at 1 to 33 rows (33: two passes of
    up to 32), q/k/v float, all int8, or mixed (k int8 beside float q and v:
    a merged-LoRA base), stacked at layer 2 of 3: one qkv_kernel launch a
    pass and no other kernel, held against its plain version, two calls
    bit-equal. The cache form writes k and v into row pos of layer 2 of an
    (L, B, T, d) cache, bit-equal to the call without one, returns views of
    those rows and leaves every other element of the cache as it was."""
    g = torch.Generator(device=dev).manual_seed(300 + B)
    bf, li, pos = torch.bfloat16, 2, 77
    x = _rn(g, dev, B, D, dtype=bf)
    lns, lnb = 1 + _rn(g, dev, L, D, scale=0.1), _rn(g, dev, L, D, scale=0.1)
    int8 = {"float": "", "int8": "qkv", "mixed": "k"}[weights]
    w = {}
    for n in "qkv":
        t = _rn(g, dev, L, D, D, scale=D ** -0.5)
        w[n] = _int8(t) if n in int8 else (t.to(bf), None)
    bq, bv = (_rn(g, dev, L, D, scale=0.1, dtype=bf) for _ in range(2))

    def call(**kw):
        return DF.fused_qkv(x, lns, lnb, w["q"][0], bq, w["k"][0], w["v"][0], bv,
                            wq_scale=w["q"][1], wk_scale=w["k"][1], wv_scale=w["v"][1],
                            layer_idx=li, **kw)
    DF.reset_kernel_launches()
    out = call()
    assert DF.kernel_launches() == {**dict.fromkeys(DF.KERNELS, 0),
                                    "qkv_kernel": -(-B // 32)}
    ref = DF.fused_qkv_plain(x, lns[li], lnb[li], w["q"][0][li], bq[li], w["k"][0][li],
                             w["v"][0][li], bv[li], wq_scale=_at_layer(w["q"][1], li),
                             wk_scale=_at_layer(w["k"][1], li),
                             wv_scale=_at_layer(w["v"][1], li))
    for o, r in zip(out, ref):
        assert o.shape == (B, D) and o.dtype == r.dtype
        _close(o, r, bf)
    assert all(torch.equal(a, b) for a, b in zip(out, call()))
    ck, cv = (_rn(g, dev, L, B, T, D, dtype=bf) for _ in range(2))
    want_k, want_v = ck.clone(), cv.clone()
    want_k[li, :, pos], want_v[li, :, pos] = out[1], out[2]
    DF.reset_kernel_launches()
    q, k, v = call(cache_k=ck, cache_v=cv, pos=pos)
    assert DF.kernel_launches()["qkv_kernel"] == -(-B // 32)
    assert sum(DF.kernel_launches().values()) == -(-B // 32)
    assert torch.equal(q, out[0]) and torch.equal(ck, want_k) and torch.equal(cv, want_v)
    assert k.data_ptr() == ck[li, :, pos].data_ptr() and torch.equal(v, out[2])


def test_fused_qkv_rejects_unsupported_shapes(dev):
    """The tensor-core qkv stages x's rows whole: a bf16 call wider than
    1280 raises and never falls back to the GEMV; fp32 takes the GEMV (one
    launch a group of 8 rows) and copies its k and v into a given cache."""
    B, d = 3, 1344
    ln = torch.ones(d, device=dev)
    x = torch.zeros(B, d, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(d, d, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(d, device=dev, dtype=torch.bfloat16)
    DF.reset_kernel_launches()
    with pytest.raises(ValueError, match="1280"):
        DF.fused_qkv(x, ln, ln, w, b, w, w, b)
    assert sum(DF.kernel_launches().values()) == 0
    g = torch.Generator(device=dev).manual_seed(9)
    x, w, b = _rn(g, dev, 12, D), _rn(g, dev, D, D, scale=D ** -0.5), _rn(g, dev, D)
    ln = torch.ones(D, device=dev)
    ck, cv = torch.zeros(12, T, D, device=dev), torch.zeros(12, T, D, device=dev)
    q, k, v = DF.fused_qkv(x, ln, ln, w, b, w, w, b, cache_k=ck, cache_v=cv, pos=5)
    assert DF.kernel_launches() == {**dict.fromkeys(DF.KERNELS, 0), "gemv_kernel": 2}
    ref = DF.fused_qkv_plain(x, ln, ln, w, b, w, w, b)
    for o, r in zip((q, ck[:, 5], cv[:, 5]), ref):
        _close(o, r, torch.float32)
    assert k.data_ptr() == ck[:, 5].data_ptr() and int(ck.count_nonzero()) == 12 * D


def test_fused_mlp_rejects_unsupported_shapes(dev):
    """The tensor-core MLP takes ff as a multiple of its 64-column tile: a
    bf16 call it cannot take raises and never falls back to the GEMV."""
    B, ff = 3, 96   # a GEMV width (16 | 96), not a tile width
    x = torch.zeros(B, D, device=dev, dtype=torch.bfloat16)
    ln = torch.ones(D, device=dev)
    w1 = torch.zeros(D, ff, device=dev, dtype=torch.bfloat16)
    w2 = torch.zeros(ff, D, device=dev, dtype=torch.bfloat16)
    b1 = torch.zeros(ff, device=dev, dtype=torch.bfloat16)
    b2 = torch.zeros(D, device=dev, dtype=torch.bfloat16)
    DF.reset_kernel_launches()
    with pytest.raises(ValueError, match="multiple of 64"):
        DF.fused_mlp(x, ln, ln, w1, b1, w2, b2)
    assert sum(DF.kernel_launches().values()) == 0
    out = DF.fused_mlp(x.float(), ln, ln, w1.float(), b1.float(), w2.float(), b2.float())
    assert DF.kernel_launches()["gemv_kernel"] == 2   # fp32: the GEMV route takes 16 | ff
    _close(out, x.float(), torch.float32)


# m, K, N of each W8A8 case, and whether it runs the wide tile
W8A8_CASES = {
    "B3": (111, 4112, 208, False),
    "B8": (296, 4112, 208, False),
    "B12": (444, 4112, 208, False),
    "one pass": (2000, 1008, 2200, True),
    "K 5120": (300, 5120, 3840, False),
    "wide ragged": (1000, 1280, 2056, True),
    # Uni-MoE's expert products at about one expert's rows of a batch of 8:
    # the down-projection's K past the quantize pass's 8192 (its two-pass
    # kernel), and the gate/up's wide N
    "K 18944": (1536, 18944, 3584, True),
    "N 18944": (1536, 3584, 18944, True),
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


@pytest.mark.parametrize("outliers", [False, True])
@pytest.mark.parametrize("shape", list(W8A8_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_with_the_row_amax_supplied_matches_plain_bitwise(dev, dtype, shape, outliers):
    """With the row amax supplied (tensor parallelism: x holds K / tp
    columns and the scale is the whole row's), the kernel equals w8a8_plain
    given the same amax, bit for bit, at every shape above: an amax above
    each row's own, the other half's loud column, pure and with the
    outlier keep-mask and addend; and it reads the operand (the result
    differs from the call without it)."""
    m, K, N, _ = W8A8_CASES[shape]
    g = torch.Generator(device=dev).manual_seed(m + 1)
    x = _rn(g, dev, m, K, dtype=dtype)
    x[:, 7] *= 50.0
    w8, ws = _int8(_rn(g, dev, K, N, scale=0.05))
    keep = addend = None
    if outliers:
        keep, addend = Q._outlier_split(x, w8, ws, Q.QuantConfig(matmul=True,
                                                                 outlier_cols=4))
    own = (x.float() if keep is None else x.float() * keep).abs().amax(-1)
    amax = torch.maximum(own, 60.0 * _rn(g, dev, m, 1).abs()[:, 0])
    WF.reset_launches()
    out = WF.w8a8(x, w8, ws, keep, addend, w8.t().contiguous(), amax)
    assert WF.LAUNCHES["w8a8"] == 1 and out.dtype == dtype and out.shape == (m, N)
    ref = WF.w8a8_plain(x, w8, ws, keep, addend, amax)
    assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())
    assert not torch.equal(out, WF.w8a8(x, w8, ws, keep, addend, w8.t().contiguous()))


def test_w8a8_rejects_a_missing_or_mismatched_copy(dev):
    """On the card the wrapper raises, and launches nothing, without the
    K-major copy, with one of another shape, dtype or device, and at a K
    that is no multiple of 16 or an N no multiple of 8 (TMA's row pitches);
    it never transposes. (A K beyond 8192 runs: the cases above.)"""
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
    assert WF.LAUNCHES["w8a8"] == 0


@pytest.mark.parametrize("K,N", [(18944, 3584), (3584, 18944), (1280, 3584)])
def test_w8a8_over_a_k_major_only_base(dev, K, N):
    """A base held only K-major (models/unimoe.py) passes w_q8 as the view
    w_nk.t(): the kernel reads w_nk alone and gives what the plain version
    gives from the view; the straight-through backward dequantizes the
    view, dy @ (w_nk · s)."""
    g = torch.Generator(device=dev).manual_seed(K + N)
    w8, ws = _int8(_rn(g, dev, K, N, scale=0.05))
    w_nk = w8.t().contiguous()
    x = _rn(g, dev, 300, K, dtype=torch.bfloat16).requires_grad_()
    WF.reset_launches()
    y = Q.int8_matmul(x, w_nk.t(), ws, Q.QuantConfig(matmul=True), w_nk)
    assert WF.LAUNCHES["w8a8"] == 1
    assert torch.equal(y, WF.w8a8_plain(x.detach(), w_nk.t(), ws))
    dy = _rn(g, dev, 300, N, dtype=torch.bfloat16)
    (y.float() * dy.float()).sum().backward()
    want = dy @ (w_nk.to(torch.bfloat16) * ws.reshape(-1, 1).to(torch.bfloat16))
    _close(x.grad, want, torch.bfloat16)


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

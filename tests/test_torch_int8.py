"""Port parity for the int8 frozen base: the W8A8 product, its autograd
Function, the int8 tree and adapter merge, and the int8-weight options of
the fused decoder kernels, against the JAX package on the CPU.

The same numpy inputs go through both. On CPU tensors the port's wrappers
run their plain versions (ops/w8a8_fused.w8a8_plain, the decoder kernels'
plain versions), which chip_smoke.py holds the CUDA kernels against on the
card; the JAX side runs the Pallas kernels in interpret mode, as the JAX
package's own tests do. Each test states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.evaluation import decode as JD
from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import WhisperConfig as JConfig
from asr_finetune_tpu.ops import decoder_fused as JDF
from asr_finetune_tpu.ops import quant as JQ
from asr_finetune_tpu.ops import w8a8_fused as JF
from asr_finetune_tpu.training import lora as JL
from asr_finetune_tpu_torch.evaluation import decode as TD
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig
from asr_finetune_tpu_torch.ops import decoder_fused as TDF
from asr_finetune_tpu_torch.ops import quant as TQ
from asr_finetune_tpu_torch.ops import w8a8_fused as TF
from asr_finetune_tpu_torch.training import lora as TL

OUTLIERS = {3: 60.0, 17: 50.0, 40: 40.0, 77: 30.0, 90: 20.0}   # column: scale


def _t(a):
    return torch.from_numpy(np.array(a))


def _w8a8_inputs(seed, m, K, N, dtype):
    """x (m, K) with five emergent outlier columns of distinct size (so the
    top-4 columns by amax, and the one after them, have no ties), an int8
    weight and its scales from quantize_weight."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)).astype(np.float32)
    for c, s in OUTLIERS.items():
        x[:, c] *= s
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    q = JQ.quantize_weight(jnp.asarray(w))
    xj = jnp.asarray(x).astype(dtype)
    return xj, np.asarray(q["w_q8"]), np.asarray(q["w_scale"])


def _jit_w8a8(x, w8, ws):
    """JAX `_w8a8_impl` under a fresh jit (the flags are read at trace time)."""
    return jax.jit(lambda a, b, c: JQ._w8a8_impl(a, b, c))(x, jnp.asarray(w8),
                                                           jnp.asarray(ws))


@pytest.fixture
def jax_int8_flags():
    """The JAX module's process-wide W8A8 flags, reset after the test."""
    yield JQ
    JQ.set_int8_outlier_cols(0)
    JQ.set_int8_outlier_static_idx(None)


# (form, outlier_cols, calibrated static sets or None)
FORMS = {"pure": (0, None), "dynamic": (4, None), "static_empty": (4, ()),
         "static": (4, (3, 17, 40, 77))}


@pytest.mark.parametrize("K,N", [(128, 512), (512, 128)])          # d → 4d, 4d → d
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", list(FORMS))
def test_w8a8_matches_jax(jax_int8_flags, form, dtype, K, N):
    """The port's W8A8 product (int8_matmul over w8a8_plain, the kernel's
    plain version) against JAX `_w8a8_impl` jitted with the same flags (as
    the JAX train step runs it: XLA turns its division by the constant 127
    into a multiply by f32(1/127), which the port computes), and for the
    pure form also against the Pallas `fused_w8a8` (interpret mode). Target:
    bit equality, reached by the pure forms. The outlier forms add an fp32
    side product of k = 4 terms, which XLA sums and adds in its own order
    (jitted, even a single term's product and add differ from a separate
    multiply and add): on these inputs they read 2.4e-7 at most (one ulp of
    the side product, whose terms reach ~4), held at 2.4e-7 |ref| + 1e-6 in
    fp32 and one bf16 step (2^-7 relative) in bf16, where that sum decides
    a rounding."""
    cols, static = FORMS[form]
    xj, w8, ws = _w8a8_inputs(5, 48, K, N, getattr(jnp, dtype))
    JQ.set_int8_outlier_cols(cols)
    if static is not None:
        JQ.set_int8_outlier_static_idx({(K, N): static})
    ref = np.asarray(_jit_w8a8(xj, w8, ws), np.float32)
    cfg = TQ.QuantConfig(matmul=True, outlier_cols=cols,
                         static_idx=None if static is None else {(K, N): static})
    x = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    out = TQ.int8_matmul(x, _t(w8), _t(ws), cfg)
    assert out.dtype == x.dtype and out.shape == (48, N)
    out = out.float().numpy()
    if form in ("pure", "static_empty"):
        np.testing.assert_array_equal(out, ref)
        pallas = JF.fused_w8a8(xj, jnp.asarray(w8), jnp.asarray(ws), mt=8,
                               interpret=True)
        np.testing.assert_array_equal(out, np.asarray(pallas, np.float32))
    elif dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=2.4e-7, atol=1e-6)
    else:
        np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=0)


def test_w8a8_split_rule_at_the_main_path_shapes():
    """The CUDA wrapper's tile rule on an H100 (132 SMs), one pass over K
    at every shape: the wide 128 x 256 tile where its tiles fill half the
    SMs (the encoder's products at m = 6000, the decoder's fc1 at m = 768,
    120 tiles), the narrow 64 x 128 elsewhere (the decoder's q/k/v/o and
    fc2, 30 wide tiles)."""
    for N in (1280, 5120, 3840):
        assert TF.wide_for(6000, N, 132)
    assert TF.wide_for(768, 5120, 132)
    assert not TF.wide_for(768, 1280, 132)
    assert not TF.wide_for(111, 208, 132)


def test_outlier_split_matches_jax_selection():
    """The kernel's keep-mask and addend operands carry JAX's outlier
    decomposition: the dynamic form keeps all but lax.top_k's columns of
    the column amax (exactly), and the addend is the fp32 side product
    x[:, idx] @ (w_q8[idx] · w_scale) (rtol 1e-6: a sum of k terms)."""
    xj, w8, ws = _w8a8_inputs(6, 32, 128, 256, jnp.float32)
    _, idx = jax.lax.top_k(jnp.max(jnp.abs(xj), axis=0), 4)
    idx = np.asarray(idx)
    keep_ref = np.ones(128, np.float32)
    keep_ref[idx] = 0.0
    x = np.asarray(xj)
    y_out = x[:, idx] @ (w8[idx].astype(np.float32) * ws.reshape(1, -1))
    keep, addend = TQ._outlier_split(_t(x), _t(w8), _t(ws),
                                     TQ.QuantConfig(matmul=True, outlier_cols=4))
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    np.testing.assert_allclose(addend.numpy(), y_out, rtol=1e-6, atol=1e-6)
    assert sorted(idx.tolist()) == [3, 17, 40, 77]


def test_int8_matmul_backward_is_straight_through():
    """dx of the autograd Function = the JAX custom_vjp's dy @ W_deqᵀ (JAX
    tests/test_ops.py:79); no gradient to the weight. fp32, rtol 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    q = JQ.quantize_weight(jnp.asarray((rng.standard_normal((128, 256)) * 0.05)
                                       .astype(np.float32)))
    dy = rng.standard_normal((8, 256)).astype(np.float32)
    jdx = jax.grad(lambda a: jnp.sum(JQ.int8_matmul(a, q["w_q8"], q["w_scale"])
                                     * jnp.asarray(dy)))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = TQ.int8_matmul(xt, _t(q["w_q8"]), _t(q["w_scale"]), TQ.QuantConfig(matmul=True))
    (y * _t(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-6)


def test_calibration_installs_the_jax_columns():
    """calibrate_int8_outliers records the column amax of every W8A8 product
    of a forward and installs the columns >= 6.0 per class, as the JAX
    function does (tests/test_ops.py:196)."""
    xj, w8, ws = _w8a8_inputs(7, 40, 128, 64, jnp.float32)
    w8s, wss = _t(np.stack([w8, w8])), _t(np.stack([ws, ws]))
    cfg = TQ.QuantConfig(matmul=True, outlier_cols=3)
    x = _t(np.asarray(xj))
    idx = TQ.calibrate_int8_outliers(
        lambda: [TQ.int8_matmul(x, w8s[i], wss[i], cfg) for i in range(2)], cfg,
        threshold=6.0, max_cols=4)
    assert idx == {(128, 64): (3, 17, 40, 77)} and cfg.static_idx == idx
    assert cfg.record is None
    try:
        JQ.set_int8_outlier_cols(3)
        jidx = JQ.calibrate_int8_outliers(
            lambda: JQ.int8_matmul(xj, jnp.asarray(w8), jnp.asarray(ws)),
            threshold=6.0, max_cols=4)
    finally:
        JQ.set_int8_outlier_cols(0)
        JQ.set_int8_outlier_static_idx(None)
    assert jidx == idx


# test_decoder_fused.py's TINY dims (4 heads of 64); specials as test_torch_decode.py
TINY = dict(vocab_size=613, num_mel_bins=16, d_model=256, encoder_layers=2,
            encoder_heads=4, decoder_layers=2, decoder_heads=4, d_ff=1024,
            max_source_positions=48, max_target_positions=64, eos_token_id=590,
            sot_token_id=591, translate_token_id=592, transcribe_token_id=593,
            no_timestamps_token_id=600, timestamp_begin_id=601, pad_token_id=590,
            first_language_token_id=592)
FORCED = [591, 592, 593]


@pytest.fixture(scope="module")
def tiny():
    """A JAX model, its int8 base (decoder and encoder), rank-4 adapters
    with non-zero deltas, and both carried into the port."""
    jcfg, tcfg = JConfig(**TINY), TConfig(**TINY)
    jparams = JW.init_params(jax.random.PRNGKey(1), jcfg)
    jq = JQ.quantize_tree_int8(jparams)
    jad = JL.init_adapters(jax.random.PRNGKey(7), jcfg,
                           JL.LoraConfig(rank=4, alpha=8.0, dropout=0.0), encoder=True)
    jad = jax.tree.map(lambda a: a + 0.01 if a.ndim == 3 else a, jad)
    carry = lambda tree: TIO.params_from_numpy(JIO._flatten(tree), "cpu")  # noqa: E731
    mel = np.random.default_rng(2).standard_normal(
        (2, 2 * jcfg.max_source_positions, jcfg.num_mel_bins)).astype(np.float32)
    return jcfg, tcfg, jparams, jq, jad, carry(jparams), carry(jq), carry(jad), mel


def test_quantize_tree_and_merge_match_jax(tiny):
    """quantize_tree_int8 of the carried float base equals the JAX int8 tree
    exactly (int8 values, fp32 scales, untouched leaves); merge_adapters of
    the carried int8 base and adapters equals JAX's within 1e-6 (the rank-4
    delta sums in another order)."""
    _, _, _, jq, jad, tp, tq, tad, _ = tiny
    ours = TIO.params_to_numpy(TQ.quantize_tree_int8(tp))
    ref = JIO._flatten(jq)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    merged = TIO.params_to_numpy(TL.merge_adapters(tq, tad))
    jmerged = JIO._flatten(JL.merge_adapters(jq, jad))
    assert set(merged) == set(jmerged)
    assert "encoder/layers/attn/q/w" in merged and "encoder/layers/attn/k/w_q8" in merged
    for k in jmerged:
        np.testing.assert_allclose(merged[k], jmerged[k], rtol=1e-6, atol=1e-6, err_msg=k)


def _int8_layer(rng, L, d_in, d_out):
    q = JQ.quantize_weight(jnp.asarray((rng.standard_normal((L, d_in, d_out))
                                        * d_in ** -0.5).astype(np.float32)))
    return np.asarray(q["w_q8"]), np.asarray(q["w_scale"])


D, B, T, S, FF, L = 256, 3, 256, 384, 512, 3
TOL = dict(rtol=2e-5, atol=2e-5)       # the JAX kernel tests' (test_decoder_fused.py)


@pytest.mark.parametrize("mix", ["int8", "mixed"])
def test_decoder_kernels_int8_weights_match_jax(mix):
    """fused_qkv, fused_attn (self and cross) and fused_mlp with int8
    weights and their per-column scales, stacked (layer 1 of 3), against the
    Pallas kernels in interpret mode (JAX tests/test_decoder_fused.py:336,
    :406): "int8" quantizes every projection, "mixed" is a merged-LoRA
    base (q/v float, k/o/fc1 int8, fc2 float). fp32; tolerance 2e-5, fc2's
    5e-5 (its scale lands after the chunk sum in the Pallas kernel)."""
    rng = np.random.default_rng(11)
    li = 1
    x = rng.standard_normal((B, D)).astype(np.float32)
    lns = (1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32)
    lnb = (0.1 * rng.standard_normal((L, D))).astype(np.float32)
    bias = {n: (0.3 * rng.standard_normal((L, D))).astype(np.float32) for n in "qvo"}
    b1 = (0.3 * rng.standard_normal((L, FF))).astype(np.float32)
    w = {n: _int8_layer(rng, L, D, D) for n in "qkvo"}
    w["fc1"], w["fc2"] = _int8_layer(rng, L, D, FF), _int8_layer(rng, L, FF, D)
    floats = {"q", "v", "fc2"} if mix == "mixed" else set()

    def wpair(n, to):
        """(weight, scale) for the JAX (to=jnp.asarray) or port (to=_t) call."""
        w8, s = w[n]
        if n in floats:
            return to((w8.astype(np.float32) * s).astype(np.float32)), None
        return to(w8), to(s)

    def both(fn_j, fn_t):
        return np.asarray(fn_j(jnp.asarray)), fn_t(_t)

    (jq, jk, jv), (tq, tk, tv) = both(
        lambda to: JDF.fused_qkv(to(x), to(lns), to(lnb), wpair("q", to)[0], to(bias["q"]),
                                 wpair("k", to)[0], wpair("v", to)[0], to(bias["v"]),
                                 wq_scale=wpair("q", to)[1], wk_scale=wpair("k", to)[1],
                                 wv_scale=wpair("v", to)[1], layer_idx=li),
        lambda to: TDF.fused_qkv(to(x), to(lns), to(lnb), wpair("q", to)[0], to(bias["q"]),
                                 wpair("k", to)[0], wpair("v", to)[0], to(bias["v"]),
                                 wq_scale=wpair("q", to)[1], wk_scale=wpair("k", to)[1],
                                 wv_scale=wpair("v", to)[1], layer_idx=li))
    for o, r in zip((tq, tk, tv), (jq, jk, jv)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)

    k = (0.3 * rng.standard_normal((L, B, T, D))).astype(np.float32)
    v = (0.3 * rng.standard_normal((L, B, T, D))).astype(np.float32)
    q = np.asarray(jq)
    for mod, to in ((JDF, jnp.asarray), (TDF, _t)):
        wo, so = wpair("o", to)
        pos = jnp.int32(100) if mod is JDF else 100
        out = mod.fused_attn(to(x), to(k), to(v), wo, to(bias["o"]), q=to(q), pos=pos,
                             wo_scale=so, layer_idx=li)
        wq, sq = wpair("q", to)
        cross = mod.fused_attn(to(x), to(k), to(v), wo, to(bias["o"]), s_valid=200,
                               ln_scale=to(lns), ln_bias=to(lnb), wq=wq, bq=to(bias["q"]),
                               wq_scale=sq, wo_scale=so, layer_idx=li)
        if mod is JDF:
            ref_self, ref_cross = np.asarray(out), np.asarray(cross)
    np.testing.assert_allclose(out.numpy(), ref_self, **TOL)
    np.testing.assert_allclose(cross.numpy(), ref_cross, **TOL)

    outs = []
    for mod, to in ((JDF, jnp.asarray), (TDF, _t)):
        w1, s1 = wpair("fc1", to)
        w2, s2 = wpair("fc2", to)
        outs.append(np.asarray(mod.fused_mlp(to(x), to(lns), to(lnb), w1, to(b1), w2,
                                             to(bias["o"]), w1_scale=s1, w2_scale=s2,
                                             layer_idx=li)))
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-5, atol=5e-5)


def _jax_decode(jparams, mel, jcfg, **kw):
    t, l = JD.greedy_decode(jparams, jnp.asarray(mel), jcfg, FORCED, 14,
                            compute_dtype=jnp.float32, **kw)
    return np.asarray(t), np.asarray(l)


@pytest.mark.parametrize("fused", [True, False])
def test_greedy_over_merged_int8_base_matches_jax(tiny, fused):
    """Greedy decode over the int8 base with adapters: the port's fused path
    (adapters merged, mixed int8/float weights through the kernels' int8
    options) and its plain path (adapters unmerged, int8 dequantized) give
    the JAX fused decode's tokens (JAX test_decoder_fused.py:306), fp32."""
    jcfg, tcfg, _, jq, jad, _, tq, tad, mel = tiny
    t_ref, l_ref = _jax_decode(jq, mel, jcfg, adapters=jad, fused=True)
    tokens, lengths = TD.greedy_decode(tq, torch.from_numpy(mel), tcfg, FORCED, 14,
                                       compute_dtype=torch.float32, fused=fused,
                                       adapters=tad)
    np.testing.assert_array_equal(tokens.numpy(), t_ref)
    np.testing.assert_array_equal(lengths.numpy(), l_ref)


def test_greedy_w_int8_matches_jax(tiny):
    """w_int8 (int8 decoder weights for the token loop) through the fused
    path equals JAX's w_int8 fused decode token for token, fp32."""
    jcfg, tcfg, jparams, _, _, tp, _, _, mel = tiny
    t_ref, _ = _jax_decode(jparams, mel, jcfg, fused=True, w_int8=True)
    tokens, _ = TD.greedy_decode(tp, torch.from_numpy(mel), tcfg, FORCED, 14,
                                 compute_dtype=torch.float32, fused=True, w_int8=True)
    np.testing.assert_array_equal(tokens.numpy(), t_ref)


def test_cast_decoder_weights_keeps_int8_and_scales(tiny):
    """The fused path's pre-cast leaves int8 weights int8 and every *_scale
    fp32 (JAX tests/test_round3_fixes.py::test_cast_decoder_weights_keeps_int8_scales_fp32)
    and casts the float leaves."""
    *_, tq, _, _ = tiny
    cast = TD._cast_decoder_weights(tq, torch.bfloat16)["decoder"]
    sa = cast["layers"]["self_attn"]
    assert sa["k"]["w_q8"].dtype == torch.int8
    assert sa["k"]["w_scale"].dtype == torch.float32
    assert sa["q"]["b"].dtype == torch.bfloat16 and cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["ln1"]["scale"].dtype == torch.float32

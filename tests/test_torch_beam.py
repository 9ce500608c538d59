"""Port parity for beam-search decoding and int8 cross-KV: the kernels' new
options, the model steps and beam_decode against the JAX package, on the CPU.

The same numpy inputs (or the JAX model's parameters, carried over with
native_io) go through both at fp32. On CPU tensors the port's wrappers run
their plain versions (which chip_smoke.py holds the CUDA kernels against);
the JAX side runs its Pallas kernels in interpret mode, as the JAX tests do.
Kernel outputs agree within 2e-5 (the JAX kernel tests' tolerance,
tests/test_decoder_fused.py), a decode step's logits within 2e-4 (two
stacks of layers summing in another order), int8 values bit for bit, and
decoded tokens and lengths exactly."""
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
from asr_finetune_tpu.training import lora as JL
from asr_finetune_tpu_torch.evaluation import decode as TD
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig
from asr_finetune_tpu_torch.ops import decoder_fused as TDF

TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-4)
D, L = 256, 3                        # 4 heads of 64, 3 stacked layers
NB, K = 2, 4                         # utterances, beams: 8 hypothesis rows
# tests/test_torch_decode.py's TINY model
TINY = dict(vocab_size=613, num_mel_bins=16, d_model=256, encoder_layers=2,
            encoder_heads=4, decoder_layers=2, decoder_heads=4, d_ff=1024,
            max_source_positions=48, max_target_positions=64, eos_token_id=590,
            sot_token_id=591, translate_token_id=592, transcribe_token_id=593,
            no_timestamps_token_id=600, timestamp_begin_id=601, pad_token_id=590,
            first_language_token_id=592)
FORCED = [591, 592, 593]
MAXLEN = 20
EOT, NO_TS, TS_BEGIN = 590, 600, 601
# every id but eot and five text tokens suppressed: eot competes at every
# step, so hypotheses finish early and the finished set is exercised
EOS_HEAVY = [i for i in range(613) if i not in (EOT, 7, 99, 250, 333, 480)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, *shape, scale=0.3):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _int8_wo(rng):
    """An int8 (L, D, D) weight and its (L, 1, D) per-column scales."""
    q = JQ.quantize_weight(jnp.asarray(_rand(rng, L, D, D, scale=D ** -0.5)))
    return np.asarray(q["w_q8"]), np.asarray(q["w_scale"])


@pytest.mark.parametrize("wo_kind", ["float", "int8"])
@pytest.mark.parametrize("pos", [0, 127, 128, 200, 255])
def test_fused_attn_beam_matches_jax(pos, wo_kind):
    """Beam self-attention over an unpermuted (L, B·K, 256, d) cache through
    a random ancestry map, stacked (layer 2 of 3), float or int8 wo."""
    rng = np.random.default_rng(pos)
    T = 256
    x, q = _rand(rng, NB * K, D, scale=1.0), _rand(rng, NB * K, D)
    k, v = _rand(rng, L, NB * K, T, D), _rand(rng, L, NB * K, T, D)
    anc = rng.integers(0, K, (NB, K, T)).astype(np.int32)
    bo = _rand(rng, L, D)
    if wo_kind == "int8":
        wo, so = _int8_wo(rng)
    else:
        wo, so = _rand(rng, L, D, D, scale=D ** -0.5), None
    ref = JDF.fused_attn_beam(jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(wo), jnp.asarray(bo), q=jnp.asarray(q),
                              pos=jnp.int32(pos), ancestry=jnp.asarray(anc),
                              wo_scale=None if so is None else jnp.asarray(so),
                              layer_idx=2)
    out = TDF.fused_attn_beam(_t(x), _t(k), _t(v), _t(wo), _t(bo), q=_t(q), pos=pos,
                              ancestry=_t(anc), wo_scale=None if so is None else _t(so),
                              layer_idx=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _grown_ancestry(rng, nb, k, T, pos):
    """The ancestry map beam_decode holds at step pos: each step writes every
    row's own key at t, then a seeded reorder gives each hypothesis a
    parent's history, so rows share prefixes as in a real decode."""
    anc = np.zeros((nb, k, T), np.int32)
    for t in range(pos):
        anc[:, :, t] = np.arange(k)
        parents = rng.integers(0, k, (nb, k))
        anc = np.take_along_axis(anc, parents[:, :, None], axis=1)
    anc[:, :, pos] = np.arange(k)
    return anc


@pytest.mark.parametrize("wo_kind", ["float", "int8"])
@pytest.mark.parametrize("pos", [63, 255])
@pytest.mark.parametrize("case", ["grown", "one_beam"])
def test_fused_attn_beam_decode_ancestries_match_jax(case, pos, wo_kind):
    """Beam self-attention against JAX over the ancestries a decode makes:
    one grown by seeded beam reorders (K = 4: shared prefixes, live rows
    fewer than K at most positions) and a single beam (K = 1: every key in
    the row's own cache row), stacked (layer 1 of 3), float or int8 wo."""
    rng = np.random.default_rng(1000 + pos)
    T, kb = 256, K if case == "grown" else 1
    n = NB * kb
    x, q = _rand(rng, n, D, scale=1.0), _rand(rng, n, D)
    k, v = _rand(rng, L, n, T, D), _rand(rng, L, n, T, D)
    anc = _grown_ancestry(rng, NB, kb, T, pos)
    if case == "grown":   # reorders shared histories: fewer live rows than beams
        assert len(set(anc[0, :, pos // 2].tolist())) < kb
    bo = _rand(rng, L, D)
    if wo_kind == "int8":
        wo, so = _int8_wo(rng)
    else:
        wo, so = _rand(rng, L, D, D, scale=D ** -0.5), None
    ref = JDF.fused_attn_beam(jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(wo), jnp.asarray(bo), q=jnp.asarray(q),
                              pos=jnp.int32(pos), ancestry=jnp.asarray(anc),
                              wo_scale=None if so is None else jnp.asarray(so),
                              layer_idx=1)
    out = TDF.fused_attn_beam(_t(x), _t(k), _t(v), _t(wo), _t(bo), q=_t(q), pos=pos,
                              ancestry=_t(anc), wo_scale=None if so is None else _t(so),
                              layer_idx=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_fused_attn_beam_with_own_rows_is_self_attention():
    """With every position owned by the row itself, the beam kernel's plain
    version is fused_attn's self-attention, bit for bit."""
    rng = np.random.default_rng(5)
    x, q = _t(_rand(rng, NB * K, D)), _t(_rand(rng, NB * K, D))
    k, v = _t(_rand(rng, NB * K, 128, D)), _t(_rand(rng, NB * K, 128, D))
    wo, bo = _t(_rand(rng, D, D, scale=D ** -0.5)), _t(_rand(rng, D))
    own = torch.arange(K, dtype=torch.int32)[None, :, None].expand(NB, K, 128).contiguous()
    beam = TDF.fused_attn_beam(x, k, v, wo, bo, q=q, pos=77, ancestry=own)
    assert torch.equal(beam, TDF.fused_attn(x, k, v, wo, bo, q=q, pos=77))


def _int8_kv(rng, B, S):
    """int8 k/v (L, B, S, D) with per-(batch, head) scales expanded over d,
    (L, B, D)."""
    q8 = rng.integers(-127, 128, (2, L, B, S, D)).astype(np.int8)
    heads = np.exp(rng.standard_normal((2, L, B, D // 64))).astype(np.float32) / 127
    return q8[0], q8[1], np.repeat(heads[0], 64, -1), np.repeat(heads[1], 64, -1)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("variant", ["group", "kv8", "group_kv8"])
def test_fused_attn_group_and_int8_kv_match_jax(variant, stacked):
    """Cross-attention with kv_group = 4 (16 rows of x over 4 KV rows), int8
    K/V with its scales (G = 1), and both, against the Pallas kernel: S 384,
    s_valid 300; stacked reads layer 1 of 3."""
    rng = np.random.default_rng(len(variant) + 10 * stacked)
    S, G = 384, (4 if variant.startswith("group") else 1)
    B = 4
    li = 1 if stacked else None
    sl = (lambda a: a) if stacked else (lambda a: a[li or 1])
    x = _rand(rng, B * G, D, scale=1.0)
    lns, lnb = 1 + _rand(rng, L, D, scale=0.1), _rand(rng, L, D, scale=0.1)
    wq, bq = _rand(rng, L, D, D, scale=D ** -0.5), _rand(rng, L, D)
    wo, bo = _rand(rng, L, D, D, scale=D ** -0.5), _rand(rng, L, D)
    if variant.endswith("kv8"):
        k, v, ks, vs = _int8_kv(rng, B, S)
    else:
        k, v, ks, vs = _rand(rng, L, B, S, D), _rand(rng, L, B, S, D), None, None
    kw = dict(s_valid=300, kv_group=G, layer_idx=li)
    ops = [sl(a) for a in (k, v, wo, bo, lns, lnb, wq, bq)]
    scales = [None if a is None else sl(a) for a in (ks, vs)]
    ref = JDF.fused_attn(jnp.asarray(x), *map(jnp.asarray, ops[:4]),
                         ln_scale=jnp.asarray(ops[4]), ln_bias=jnp.asarray(ops[5]),
                         wq=jnp.asarray(ops[6]), bq=jnp.asarray(ops[7]),
                         k_scale=None if ks is None else jnp.asarray(scales[0]),
                         v_scale=None if vs is None else jnp.asarray(scales[1]), **kw)
    out = TDF.fused_attn(_t(x), *map(_t, ops[:4]), ln_scale=_t(ops[4]),
                         ln_bias=_t(ops[5]), wq=_t(ops[6]), bq=_t(ops[7]),
                         k_scale=None if ks is None else _t(scales[0]),
                         v_scale=None if vs is None else _t(scales[1]), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_quantize_cross_kv_bit_equal_to_jax():
    """int8 values and fp32 scales equal the jitted JAX quantize_cross_kv
    (the form the JAX decode runs: XLA turns `/ 127.0` into a multiply by
    f32(1/127), which moves some scales one ulp and then whole int8 steps;
    with these inputs it does, so the test tells the two forms apart)."""
    rng = np.random.default_rng(0)
    kv = {"k": rng.standard_normal((2, 3, 40, 4, 64)).astype(np.float32),
          "v": (3 * rng.standard_normal((2, 3, 40, 4, 64))).astype(np.float32)}
    ref = jax.jit(JW.quantize_cross_kv)({n: jnp.asarray(a) for n, a in kv.items()})
    ours = TW.quantize_cross_kv({n: _t(a) for n, a in kv.items()})
    assert set(ours) == set(ref) == {"k_q8", "k_scale", "v_q8", "v_scale"}
    for name, r in ref.items():
        assert ours[name].dtype == {"int8": torch.int8, "float32": torch.float32}[str(r.dtype)]
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(r), err_msg=name)
    eager_scale = np.maximum(np.abs(kv["k"]).max(axis=(2, 4), keepdims=True), 1e-8) \
        / np.float32(127)
    assert (eager_scale != ours["k_scale"].numpy()).any()


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JConfig(**TINY), TConfig(**TINY)
    jparams = JW.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = TIO.params_from_numpy(JIO._flatten(jparams), "cpu")
    mel = np.random.default_rng(2).standard_normal(
        (3, 2 * jcfg.max_source_positions, jcfg.num_mel_bins)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, mel


@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_steps_with_beam_options_match_jax(tiny, kv_int8):
    """One step of B·K = 8 hypothesis rows at pos 40 over cross K/V of B = 2
    rows (cross_group 4), float or int8: JAX decode_step on the cache laid
    out per hypothesis; the port's decode_step on the same cache, and its
    decode_step_fused on the unpermuted cache through a random ancestry map
    (cross K/V padded to 128 for the kernels)."""
    jcfg, tcfg, jparams, tparams, _ = tiny
    rng = np.random.default_rng(3)
    H, hd, T, S, pos = 4, 64, 128, 48, 40
    Ld = jcfg.decoder_layers
    token = rng.integers(0, 590, NB * K).astype(np.int32)
    cache = _rand(rng, Ld, NB * K, T, D)                     # unpermuted rows
    anc = rng.integers(0, K, (NB, K, T)).astype(np.int32)
    anc[:, :, pos:] = np.arange(K)[None, :, None]            # the step writes its own row
    rows = (np.arange(NB)[:, None, None] * K + anc).reshape(NB * K, T)
    per_hyp = cache[:, rows, np.arange(T)[None, :]]          # (L, B·K, T, D)
    cross = {n: _rand(rng, Ld, NB, S, H, hd, scale=1.0) for n in ("k", "v")}
    jcross = {n: jnp.asarray(a) for n, a in cross.items()}
    tcross = {n: _t(a) for n, a in cross.items()}
    if kv_int8:
        jcross = jax.jit(JW.quantize_cross_kv)(jcross)
        tcross = TW.quantize_cross_kv(tcross)
    split = lambda a: a.reshape(Ld, NB * K, T, H, hd)        # noqa: E731
    ref, _ = JW.decode_step(jparams, jnp.asarray(token), jnp.int32(pos),
                            {"k": jnp.asarray(split(per_hyp)),
                             "v": jnp.asarray(split(per_hyp))},
                            jcross, jcfg, compute_dtype=jnp.float32, cross_group=K)
    ref = np.asarray(ref)
    plain, pc = TW.decode_step(tparams, _t(token).long(), pos,
                               {"k": _t(split(per_hyp)), "v": _t(split(per_hyp))},
                               tcross, tcfg, torch.float32, cross_group=K)
    np.testing.assert_allclose(plain.numpy(), ref, **STEP_TOL)
    fused_cross, s_real, _ = TD._prepare_fused(torch.zeros(NB, S, D), tcross, T,
                                               torch.float32)
    assert s_real == S and fused_cross[next(iter(fused_cross))].shape[2] == 128
    fused, fc = TW.decode_step_fused(
        TD._cast_decoder_weights(tparams, torch.float32), _t(token).long(), pos,
        {"k": _t(cache), "v": _t(cache)}, fused_cross, tcfg, s_real, torch.float32,
        ancestry=_t(anc), cross_group=K)
    np.testing.assert_allclose(fused.numpy(), ref, **STEP_TOL)
    # both wrote each row's own k at pos, the fused step in the unpermuted cache
    np.testing.assert_allclose(fc["k"][:, :, pos].numpy(),
                               pc["k"][:, :, pos].reshape(Ld, NB * K, D).numpy(), **TOL)


def _adapters(jcfg):
    jad = JL.init_adapters(jax.random.PRNGKey(7), jcfg,
                           JL.LoraConfig(rank=4, alpha=8.0, dropout=0.0), encoder=True)
    jad = jax.tree.map(lambda a: a + 0.01 if a.ndim == 3 else a, jad)
    return jad, TIO.params_from_numpy(JIO._flatten(jad), "cpu")


# (beams, length penalty, options): together K in {2, 4}, penalties 0.5 / 1
# / 2, the suppress lists (eos-heavy, so hypotheses finish), the timestamp
# grammar, kv_int8, w_int8 and adapters merged
CASES = {
    "K4_lp05_suppress_kv8": (4, 0.5, dict(suppress_tokens=EOS_HEAVY,
                                           begin_suppress_tokens=[EOT], kv_int8=True)),
    "K2_lp05_suppress": (2, 0.5, dict(suppress_tokens=EOS_HEAVY)),
    "K4_lp2_timestamps_w8": (4, 2.0, dict(timestamp_begin=TS_BEGIN,
                                           no_timestamps_id=NO_TS, w_int8=True)),
    "K4_lp1_adapters": (4, 1.0, dict(adapters=True)),
}


@pytest.fixture(scope="module")
def jax_beams(tiny):
    """JAX beam_decode per case, jitted as its make_decode_fn runs it, with
    the fused Pallas step (interpret mode)."""
    jcfg, _, jparams, _, mel = tiny
    jad, _ = _adapters(jcfg)
    out = {}
    for name, (nb, lp, kw) in CASES.items():
        kw = dict(kw)
        ad = jad if kw.pop("adapters", False) else None
        fn = JD.make_decode_fn(jcfg, FORCED, MAXLEN, nb, lp, jnp.float32, fused=True, **kw)
        t, l = fn(jparams, jnp.asarray(mel), ad)
        out[name] = (np.asarray(t), np.asarray(l))
    return out


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_beam_decode_equals_jax(tiny, jax_beams, case, fused):
    jcfg, tcfg, _, tparams, mel = tiny
    nb, lp, kw = CASES[case]
    kw = dict(kw)
    if kw.pop("adapters", False):
        kw["adapters"] = _adapters(jcfg)[1]
    tokens, lengths = TD.beam_decode(tparams, torch.from_numpy(mel), tcfg, FORCED,
                                     MAXLEN, nb, lp, torch.float32, fused=fused, **kw)
    t_ref, l_ref = jax_beams[case]
    np.testing.assert_array_equal(tokens.numpy(), t_ref)
    np.testing.assert_array_equal(lengths.numpy(), l_ref)
    if case == "K2_lp05_suppress":            # hypotheses finished before max length
        assert (lengths < MAXLEN).all()
    if "timestamps" in case:                  # the grammar acted
        assert (tokens[:, len(FORCED)] >= TS_BEGIN).all()


def test_beam_reorder_equals_ancestry(tiny, jax_beams, monkeypatch):
    """ASR_TPU_BEAM_REORDER=1: the fused kernels with the whole cache
    reordered each step give the ancestry path's (and JAX's) tokens."""
    _, tcfg, _, tparams, mel = tiny
    nb, lp, kw = CASES["K2_lp05_suppress"]
    monkeypatch.setenv("ASR_TPU_BEAM_REORDER", "1")
    tokens, lengths = TD.beam_decode(tparams, torch.from_numpy(mel), tcfg, FORCED,
                                     MAXLEN, nb, lp, torch.float32, fused=True, **kw)
    np.testing.assert_array_equal(tokens.numpy(), jax_beams["K2_lp05_suppress"][0])
    np.testing.assert_array_equal(lengths.numpy(), jax_beams["K2_lp05_suppress"][1])


def test_mid_loop_state_equals_jax(tiny, monkeypatch):
    """The whole loop state after 2 steps (forced prefix: hundreds of
    candidates tie at -1e9, where lax.top_k takes the lowest index) and
    after 9 (finished hypotheses collected) equals JAX's while_loop carry:
    running tokens, ancestry map, finished tokens and lengths, done, scores
    within 2e-4."""
    jcfg, tcfg, jparams, tparams, mel = tiny
    steps = (2, 9)
    carries = []

    def first_steps(cond, body, carry):
        jbody = jax.jit(body)
        for _ in range(max(steps)):
            carry = jbody(carry)
            carries.append(carry)
        return carry

    monkeypatch.setattr(jax.lax, "while_loop", first_steps)
    JD.beam_decode(jparams, jnp.asarray(mel), jcfg, FORCED, MAXLEN, num_beams=K,
                   length_penalty=0.5, compute_dtype=jnp.float32,
                   suppress_tokens=EOS_HEAVY, fused=True)
    monkeypatch.undo()
    ours = {}
    for st in TD.beam_states(tparams, torch.from_numpy(mel), tcfg, FORCED, MAXLEN, K,
                             0.5, torch.float32, suppress_tokens=EOS_HEAVY, fused=True):
        if st.t in steps:
            ours[st.t] = {n: getattr(st, n).clone() for n in
                          ("tokens", "anc", "fin_tokens", "fin_lens", "done",
                           "scores", "fin_scores")}
        if st.t == max(steps):
            break
    for n in steps:
        (t, tokens, _, scores, fin_tokens, fin_scores, fin_lens, _, done,
         anc) = carries[n - 1]
        assert int(t) == n
        got = ours[n]
        for name, ref in (("tokens", tokens), ("anc", anc), ("fin_tokens", fin_tokens),
                          ("fin_lens", fin_lens), ("done", done)):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref),
                                          err_msg=f"{name} at step {n}")
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(scores), **STEP_TOL)
        np.testing.assert_allclose(got["fin_scores"].numpy(), np.asarray(fin_scores),
                                   **STEP_TOL)
    assert (ours[9]["fin_scores"] > TD.BEAM_NEG / 2).any()   # finished hypotheses
    assert (ours[9]["anc"] != torch.arange(K, dtype=torch.int32)[None, :, None]).any()


WIDE = 10   # beams beyond the Pallas kernels' 8: a CUDA block serves 8 + 2


def test_wide_beams_run_fused(tiny):
    """K > 8 takes the fused path by default on a card (the JAX package
    routes it to its plain step; the port has no plain fallback there):
    fused and plain beam_decode give JAX's tokens and lengths at K = 10."""
    jcfg, tcfg, jparams, tparams, mel = tiny
    assert TD._resolve_fused(None, tcfg, torch.device("cuda"))
    assert not TD._resolve_fused(None, tcfg, torch.device("cpu"))
    maxlen = 8
    t_ref, l_ref = JD.beam_decode(jparams, jnp.asarray(mel[:2]), jcfg, FORCED, maxlen,
                                  num_beams=WIDE, length_penalty=1.0,
                                  compute_dtype=jnp.float32, suppress_tokens=EOS_HEAVY)
    for fused in (True, False):
        tokens, lengths = TD.beam_decode(tparams, torch.from_numpy(mel[:2]), tcfg, FORCED,
                                         maxlen, WIDE, 1.0, torch.float32,
                                         suppress_tokens=EOS_HEAVY, fused=fused)
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(t_ref), err_msg=str(fused))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(l_ref), err_msg=str(fused))


def test_wide_beam_kernels_match_per_hypothesis_attention():
    """At K = 10 the beam self-attention equals fused_attn over each
    hypothesis' gathered history, and kv_group 10 equals kv_group 1 over the
    cross K/V replicated per hypothesis (the Pallas kernels stop at 8, so
    the port's own single-query attention is the reference)."""
    rng = np.random.default_rng(11)
    T, n = 128, NB * WIDE
    x, q = _t(_rand(rng, n, D, scale=1.0)), _t(_rand(rng, n, D))
    k, v = _t(_rand(rng, n, T, D)), _t(_rand(rng, n, T, D))
    wo, bo = _t(_rand(rng, D, D, scale=D ** -0.5)), _t(_rand(rng, D))
    anc = rng.integers(0, WIDE, (NB, WIDE, T)).astype(np.int32)
    rows = _t((np.arange(NB)[:, None, None] * WIDE + anc).reshape(n, T)).long()
    cols = torch.arange(T)[None, :]
    beam = TDF.fused_attn_beam(x, k, v, wo, bo, q=q, pos=90, ancestry=_t(anc))
    ref = TDF.fused_attn(x, k[rows, cols], v[rows, cols], wo, bo, q=q, pos=90)
    np.testing.assert_allclose(beam.numpy(), ref.numpy(), **TOL)
    lns, lnb = _t(1 + _rand(rng, D, scale=0.1)), _t(_rand(rng, D, scale=0.1))
    wq, bq = _t(_rand(rng, D, D, scale=D ** -0.5)), _t(_rand(rng, D))
    cross = dict(ln_scale=lns, ln_bias=lnb, wq=wq, bq=bq, s_valid=100)
    grouped = TDF.fused_attn(x, k[::WIDE], v[::WIDE], wo, bo, kv_group=WIDE, **cross)
    rep = TDF.fused_attn(x, k[::WIDE].repeat_interleave(WIDE, 0),
                         v[::WIDE].repeat_interleave(WIDE, 0), wo, bo, **cross)
    np.testing.assert_allclose(grouped.numpy(), rep.numpy(), **TOL)

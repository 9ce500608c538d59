"""Port parity for the fused-qkv encoder path and the two attention layouts it
adds: asr_finetune_tpu_torch against the JAX package on the CPU, fp32 unless
stated, the same numpy inputs (or the JAX model's parameters, carried by
params_from_numpy) on both sides, the Pallas kernels in interpret mode.

- ops/encoder_attention: `dense_attention` over (BH, T, hd) and
  `dense_attention_qkv` over one (B, T, 3D) buffer (plain versions, the
  wrappers' CPU path), forward and gradients; `encoder_attention` under
  ASR_TPU_DENSE_PACKED=0 and ASR_TPU_DENSE_NATIVE_T=0;
- models/whisper: `encode` under ASR_TPU_FUSED_QKV=1 (adapters, the int8
  base dequantized and as W8A8, full fine-tuning gradients through the
  weight concat, dropout masks, a merged mixed int8/float base), the gate's
  modes;
- run.calibrate_outliers under ASR_TPU_FUSED_QKV=1 (the JAX classes only),
  two PEFT steps with W8A8 on the fused path against the jitted JAX step, and
  `cli.train --peft --int8_matmul` with its eval decode through the fused
  decode on the CPU.

The shapes are tests/test_fused_qkv.py's (d_model 128, 2 heads of 64)."""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import get_config as jget_config
from asr_finetune_tpu.ops import encoder_attention as JEA
from asr_finetune_tpu.ops import quant as JQ
from asr_finetune_tpu.training import lora as JL
from asr_finetune_tpu.training import optim as JO
from asr_finetune_tpu.training import train_step as JTS
from asr_finetune_tpu_torch import run as TR
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import get_config as tget_config
from asr_finetune_tpu_torch.ops import encoder_attention as TEA
from asr_finetune_tpu_torch.ops import quant as TQ
from asr_finetune_tpu_torch.training import lora as TL
from asr_finetune_tpu_torch.training import optim as TO
from asr_finetune_tpu_torch.training import train_step as TTS

FUSED_CFG = dict(d_model=128, encoder_heads=2, decoder_heads=2, d_ff=256)
JCFG = dataclasses.replace(jget_config("test-nano"), **FUSED_CFG)
TCFG = dataclasses.replace(tget_config("test-nano"), **FUSED_CFG)
BF16_TOL = dict(rtol=2.0 ** -7, atol=2e-3)   # one bf16 step of the value, and flips upstream


def _carry(tree):
    return TIO.params_from_numpy(JIO._flatten(tree), "cpu")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(x):
    return (x.float().detach().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _fused_env(monkeypatch, mode):
    monkeypatch.setenv("ASR_TPU_FUSED_QKV", mode)


# ---------------------------------------------------------------------------
# ops/encoder_attention: the two new layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_attention_matches_jax(dtype):
    """(BH, T_p, hd) = (4, 256, 64), keys valid below 150 (T 150 padded to
    256 with zero rows, as encoder_attention pads them): the plain forward
    and the gradients of sum(out * g) against JAX `dense_attention`
    (interpret mode) and jax.grad. fp32 at the JAX test's 1e-5 (forward) and
    rtol 1e-4 + 1e-5 (grads); bf16 within one bf16 step of the value (the
    two round the same intermediates to bf16, in other sum orders)."""
    rng = np.random.default_rng(0)
    T, T_p, s_valid = 150, 256, 150
    q, k, v = (np.zeros((4, T_p, 64), np.float32) for _ in range(3))
    for a in (q, k, v):
        a[:, :T] = rng.standard_normal((4, T, 64)) * 0.3
    g = rng.standard_normal((4, T_p, 64)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (_j(a, jdt) for a in (q, k, v))

    def jloss(q_, k_, v_):
        out = JEA.dense_attention(q_, k_, v_, s_valid, True)
        return jnp.sum(out.astype(jnp.float32) * _j(g)), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)

    tq, tk, tv = (_t(a, tdt).requires_grad_() for a in (q, k, v))
    out = TEA.dense_attention(tq, tk, tv, s_valid)
    assert out.dtype == tdt and out.shape == (4, T_p, 64)
    (out.float() * _t(g)).sum().backward()
    fwd_tol, grad_tol = ((dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-4, atol=1e-5))
                         if dtype == "float32" else (BF16_TOL, BF16_TOL))
    np.testing.assert_allclose(_np(out), _np(jout), **fwd_tol)
    assert np.isfinite(_np(out)).all()     # the zero-padded query rows too
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=f"d{name}", **grad_tol)
    # keys past s_valid get no gradient
    assert not tk.grad[:, s_valid:].any() and not tv.grad[:, s_valid:].any()


def test_dense_attention_qkv_matches_jax():
    """One (B, T, 3D) = (2, 256, 384) buffer, 2 heads of 64
    (tests/test_fused_qkv.py::test_kernel_fused_qkv_matches_xla's shape):
    the plain forward and the (B, T, 3D) cotangent against JAX
    `dense_attention_qkv` (interpret mode), at the packed JAX test's 1e-5
    and rtol 1e-4 + 1e-5; the autograd backward, the plain backward and the
    JAX VJP are one (B, T, 3D) buffer each."""
    rng = np.random.default_rng(1)
    qkv = (rng.standard_normal((2, 256, 384)) * 0.5).astype(np.float32)
    g = rng.standard_normal((2, 256, 128)).astype(np.float32)
    jout, vjp = jax.vjp(lambda x: JEA.dense_attention_qkv(x, 64, True), _j(qkv))
    (jgrad,) = vjp(_j(g))

    x = _t(qkv).requires_grad_()
    out = TEA.dense_attention_qkv(x, 64)
    out.backward(_t(g))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)
    assert x.grad.shape == (2, 256, 384)
    np.testing.assert_allclose(_np(x.grad), _np(jgrad), rtol=1e-4, atol=1e-5)
    plain = TEA.dense_attention_qkv_bwd_plain(_t(qkv), _t(g), 64)
    np.testing.assert_array_equal(plain.numpy(), x.grad.numpy())
    # the packed form on the three column blocks is the same function
    np.testing.assert_array_equal(
        TEA.dense_attention_packed_plain(*(_t(qkv)[..., i * 128:(i + 1) * 128]
                                           for i in range(3)), 64, 256).numpy(),
        _np(out))


@pytest.mark.parametrize("packed,native", [("0", "1"), ("1", "0"), ("0", "0")])
def test_encoder_attention_layouts_match_jax(monkeypatch, packed, native):
    """encoder_attention under ASR_TPU_DENSE_PACKED / ASR_TPU_DENSE_NATIVE_T
    against the JAX function under the same switches (interpret mode): Tq 150
    and Tk 150 (rows padded to 256), and the cross shape Tq 40, Tk 150;
    forward at 1e-5 and the grads of sum(out**2) at rtol 1e-4 + 1e-5, as
    the JAX test."""
    monkeypatch.setenv("ASR_TPU_DENSE_PACKED", packed)
    monkeypatch.setenv("ASR_TPU_DENSE_NATIVE_T", native)
    rng = np.random.default_rng(2)
    for Tq, Tk in ((150, 150), (40, 150)):
        q, k, v = ((rng.standard_normal((2, T, 4, 64)) * 0.3).astype(np.float32)
                   for T in (Tq, Tk, Tk))

        def jloss(*a):
            out = JEA.encoder_attention(*a, interpret=True)
            return jnp.sum(out ** 2), out
        (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            *map(_j, (q, k, v)))
        ts = [_t(a).requires_grad_() for a in (q, k, v)]
        out = TEA.encoder_attention(*ts)
        assert out.shape == (2, Tq, 4, 64)
        (out ** 2).sum().backward()
        np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)
        for name, a, b in zip("qkv", ts, jgrads):
            np.testing.assert_allclose(_np(a.grad), _np(b), rtol=1e-4, atol=1e-5,
                                       err_msg=f"d{name}")


def test_encoder_attention_reads_the_switches_at_every_call(monkeypatch):
    """The layout follows the environment of each call (never cached):
    packed by default, the (BH, T_p, hd) form with rows padded to 128 under
    ASR_TPU_DENSE_PACKED=0, the packed form padded to 128 under
    ASR_TPU_DENSE_NATIVE_T=0; every form gives the same numbers."""
    seen = []
    orig_bh, orig_packed = TEA.dense_attention, TEA.dense_attention_packed
    monkeypatch.setattr(TEA, "dense_attention",
                        lambda q, k, v, s: seen.append(("bh", q.shape, s)) or orig_bh(q, k, v, s))
    monkeypatch.setattr(TEA, "dense_attention_packed",
                        lambda q, k, v, hd, s: seen.append(("packed", q.shape, s))
                        or orig_packed(q, k, v, hd, s))
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.standard_normal((2, 150, 2, 64)) * 0.3) for _ in range(3))
    outs = []
    for packed, native in (("1", "1"), ("0", "1"), ("1", "0"), ("1", "1")):
        monkeypatch.setenv("ASR_TPU_DENSE_PACKED", packed)
        monkeypatch.setenv("ASR_TPU_DENSE_NATIVE_T", native)
        outs.append(TEA.encoder_attention(q, k, v))
    assert seen == [("packed", (2, 150, 128), 150), ("bh", (4, 256, 64), 150),
                    ("packed", (2, 256, 128), 150), ("packed", (2, 150, 128), 150)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-6, atol=1e-6)


def test_fused_qkv_supported():
    """The port's shape rule: 64-dim heads, T >= 128, the packed native-T
    layout on; any head count (the TPU's lane grouping is not ported)."""
    assert TEA.fused_qkv_supported(20, 64, 1500)
    assert TEA.fused_qkv_supported(3, 64, 128)
    assert not TEA.fused_qkv_supported(2, 32, 256)
    assert not TEA.fused_qkv_supported(2, 64, 127)


# ---------------------------------------------------------------------------
# models/whisper: encode on the fused path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """tests/test_fused_qkv.py's setup: the JAX model, rank-4 adapters on
    encoder and decoder q/v with b moved off zero, a (1, 256, 80) mel; and
    the same carried into the port."""
    p = JW.init_params(jax.random.PRNGKey(0), JCFG)
    adp = JL.init_adapters(jax.random.PRNGKey(1), JCFG, JL.LoraConfig(rank=4, alpha=8.0),
                           encoder=True)
    b_rng = np.random.default_rng(9)
    adp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.05 * b_rng.standard_normal(a.shape), jnp.float32)
        if path[-1].key == "b" else a, adp)
    mel = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 256, JCFG.num_mel_bins)))
    return p, adp, mel


@pytest.fixture
def jax_w8a8():
    """The JAX module's process-wide W8A8 switches, off again after the test."""
    yield JQ
    JQ.set_int8_compute(False)
    JQ.set_int8_outlier_cols(0)
    JQ.set_int8_outlier_static_idx(None)


@pytest.mark.parametrize("base,adapters", [("float", False), ("float", True),
                                           ("int8", True), ("w8a8", True)])
def test_encode_fused_matches_jax(model, monkeypatch, jax_w8a8, base, adapters):
    """`encode` under ASR_TPU_FUSED_QKV=1 against the JAX fused `encode`
    (interpret-mode `dense_attention_qkv`), fp32, remat on: without and with
    adapters, over the int8 base dequantized and as W8A8 with 2 dynamic
    outlier columns (the wide (d, 3d) product has no calibrated class). The
    port's fused path ran: the wide weights were built. 1e-4, the JAX
    fused-vs-unfused test's tolerance; W8A8 within 2e-2, as
    tests/test_torch_peft.py holds it (the frameworks' fp32 activations
    differ in the last bits, which now and then flips an int8 rounding: one
    step is 1/127 of a row's amax)."""
    p, adp, mel = model
    jp = JQ.quantize_tree_int8(p) if base != "float" else p
    matmul = base == "w8a8"
    JQ.set_int8_compute(matmul)
    JQ.set_int8_outlier_cols(2 if matmul else 0)
    _fused_env(monkeypatch, "1")
    ref = JW.encode(jp, jnp.asarray(mel), JCFG, adapters=adp if adapters else None,
                    compute_dtype=jnp.float32, remat=True)
    built = []
    orig = TW._fuse_qkv_weights
    monkeypatch.setattr(TW, "_fuse_qkv_weights", lambda a: built.append(1) or orig(a))
    quant = TQ.QuantConfig(matmul=True, outlier_cols=2) if matmul else None
    out = TW.encode(_carry(jp), _t(mel), TCFG, torch.float32, remat=True,
                    adapters=_carry(adp) if adapters else None, quant=quant)
    assert built == [1]
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=2e-2 if matmul else 1e-4)


def _grads(loss, leaves_):
    loss.backward()
    return [t.grad.clone() for t in leaves_]


def _close_tree(ours, ref, frac):
    """Every leaf within frac x its largest |gradient| + 1e-5 (the form of
    the JAX fused tests' gradient tolerance)."""
    assert set(ours) == set(ref)
    for k in ref:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        tol = frac * float(np.abs(b).max()) + 1e-5
        assert float(np.abs(a - b).max()) < tol, k


def test_full_finetune_grads_through_the_weight_concat(model, monkeypatch):
    """Full fine-tuning: the gradients of sum(encode**2) on every encoder
    leaf, the separate q/k/v weights and biases included, through the fused
    (L, d, 3d) concat: the port's fused path against the JAX fused path and
    against the port's unfused path, each leaf within the JAX test's 5e-3 of
    its largest gradient (the port's unfused path reads 4e-3 against the
    JAX unfused one on this loss: the frameworks' fp32 sums differ in order
    and the loss's layer-norm backward cancels)."""
    p, _, mel = model
    _fused_env(monkeypatch, "1")
    jg = jax.grad(lambda pp: jnp.sum(JW.encode(pp, jnp.asarray(mel), JCFG,
                                               compute_dtype=jnp.float32,
                                               remat=True) ** 2))(p)
    ref = {k: v for k, v in JIO._flatten(jg).items() if k.startswith("encoder/")}

    def port_grads(mode):
        _fused_env(monkeypatch, mode)
        tp = _carry(p)
        leaves_ = dict(TO.leaves(tp["encoder"]))
        for t in leaves_.values():
            t.requires_grad_(True)
        out = TW.encode(tp, _t(mel), TCFG, torch.float32, remat=True)
        grads = _grads((out ** 2).sum(), list(leaves_.values()))
        return {f"encoder/{k}": g.numpy() for k, g in zip(leaves_, grads)}

    fused, unfused = port_grads("1"), port_grads("0")
    assert np.abs(fused["encoder/layers/attn/k/w"]).max() > 0
    _close_tree(fused, ref, 5e-3)
    _close_tree(fused, unfused, 5e-3)


def test_adapter_grads_match_jax(model, monkeypatch):
    """PEFT: the adapter gradients of sum(encode**2) over the int8 base
    dequantized, the port's fused path against the JAX fused path and
    against the port's unfused path, within the JAX test's 5e-3 of each
    leaf's largest: the q/v deltas' fused block form reaches a, e and b of
    both adapters."""
    p, adp, mel = model
    jq = JQ.quantize_tree_int8(p)
    _fused_env(monkeypatch, "1")
    jg = jax.grad(lambda a: jnp.sum(JW.encode(jq, jnp.asarray(mel), JCFG, adapters=a,
                                              compute_dtype=jnp.float32,
                                              remat=True) ** 2))(adp)
    ref = {k: v for k, v in JIO._flatten(jg).items() if k.startswith("encoder/")}

    def port_grads(mode):
        _fused_env(monkeypatch, mode)
        tad = _carry(adp)
        leaves_ = dict(TO.leaves(tad["encoder"]))
        for t in leaves_.values():
            t.requires_grad_(True)
        out = TW.encode(_carry(jq), _t(mel), TCFG, torch.float32, remat=True, adapters=tad)
        grads = _grads((out ** 2).sum(), list(leaves_.values()))
        return {f"encoder/{k}": g.numpy() for k, g in zip(leaves_, grads)}

    fused = port_grads("1")
    assert np.abs(fused["encoder/v/b"]).max() > 0 and np.abs(fused["encoder/q/e"]).max() > 0
    _close_tree(fused, ref, 5e-3)
    _close_tree(fused, port_grads("0"), 5e-3)


def test_fused_dropout_masks_are_the_unfused_ones(model, monkeypatch):
    """Lora dropout 0.3 on the fused path draws the unfused path's masks (the
    sites enc/{l}/q and enc/{l}/v): outputs within the JAX test's 1e-4, and
    at each site the fused path draws exactly the masks the unfused path
    draws, on the same inputs."""
    p, adp, mel = model
    tp, tad = _carry(p), _carry(adp)
    sites = {}
    real = TW.LoraDropout.__call__

    def record(self, x, site):
        y = real(self, x, site)
        sites.setdefault(site, []).append((x.detach().clone(), y.detach().clone()))
        return y
    monkeypatch.setattr(TW.LoraDropout, "__call__", record)
    drop = TW.LoraDropout(0.3, seed=5, step=2)
    outs = {}
    for mode in ("0", "1"):
        _fused_env(monkeypatch, mode)
        outs[mode] = TW.encode(tp, _t(mel), TCFG, torch.float32, adapters=tad, dropout=drop)
    np.testing.assert_allclose(_np(outs["1"]), _np(outs["0"]), rtol=1e-4, atol=1e-4)
    assert sorted(sites) == [f"enc/{l}/{n}" for l in range(2) for n in "qv"]
    for site, ((x0, y0), (x1, y1)) in sites.items():
        torch.testing.assert_close(x1, x0, rtol=1e-4, atol=1e-4)
        assert torch.equal(y0 == 0, y1 == 0), site     # one mask


def test_merged_mixed_base_takes_the_unfused_path(model, monkeypatch):
    """The eval decode's merged PEFT base over int8 (q and v float, k int8):
    the JAX fused `encode` raises AssertionError in `_fuse_qkv_weights`; the
    port's serves it by the three projections, equal (1e-4) to the JAX
    unfused `encode` of the same merged tree."""
    p, adp, mel = model
    merged = JL.merge_adapters(JQ.quantize_tree_int8(p), adp)
    _fused_env(monkeypatch, "1")
    with pytest.raises(AssertionError, match="mixed int8/float"):
        JW.encode(merged, jnp.asarray(mel), JCFG, compute_dtype=jnp.float32)
    out = TW.encode(_carry(merged), _t(mel), TCFG, torch.float32)
    _fused_env(monkeypatch, "0")
    ref = JW.encode(merged, jnp.asarray(mel), JCFG, compute_dtype=jnp.float32)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="mixed int8/float"):
        TW._fuse_qkv_weights(_carry(merged)["encoder"]["layers"]["attn"])


@pytest.mark.parametrize("mode,impl,device,want", [
    ("0", "auto", "cuda", False), ("1", "auto", "cpu", True), ("1", "xla", "cpu", False),
    ("force", "xla", "cpu", True), ("auto", "auto", "cpu", False),
    ("auto", "auto", "cuda", True), ("auto", "xla", "cuda", False)])
def test_gate_modes(monkeypatch, mode, impl, device, want):
    """_fused_qkv_ok: 0 off; 1 on for impl auto, yielding to an explicit
    xla; force on whatever impl says; auto where the dispatch runs the
    attention kernel (impl auto on a CUDA device)."""
    _fused_env(monkeypatch, mode)
    assert TW._fused_qkv_ok(TCFG, 256, impl, torch.device(device)) is want


def test_gate_shapes_and_environment_read_every_call(monkeypatch):
    """hd != 64 or T < 128 keep the three projections; the environment is
    read at every call; the packed-layout switches gate it too."""
    cpu = torch.device("cpu")
    _fused_env(monkeypatch, "1")
    assert TW._fused_qkv_ok(TCFG, 128, "auto", cpu)
    assert not TW._fused_qkv_ok(TCFG, 127, "auto", cpu)
    assert not TW._fused_qkv_ok(dataclasses.replace(TCFG, d_model=64), 256, "auto", cpu)
    monkeypatch.setenv("ASR_TPU_DENSE_NATIVE_T", "0")
    assert not TW._fused_qkv_ok(TCFG, 256, "auto", cpu)
    monkeypatch.delenv("ASR_TPU_DENSE_NATIVE_T")
    _fused_env(monkeypatch, "0")
    assert not TW._fused_qkv_ok(TCFG, 256, "auto", cpu)
    monkeypatch.delenv("ASR_TPU_FUSED_QKV")
    assert not TW._fused_qkv_ok(TCFG, 256, "auto", cpu)


# ---------------------------------------------------------------------------
# training: calibration, the train step, the CLI
# ---------------------------------------------------------------------------

# tests/test_torch_peft.py's SMALL (64-dim heads, 150 encoder frames: the
# fused gate's T >= 128 holds)
SMALL = dict(vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
             encoder_heads=2, decoder_layers=2, decoder_heads=2, d_ff=256,
             max_source_positions=150, max_target_positions=32,
             eos_token_id=290, sot_token_id=291, translate_token_id=293,
             transcribe_token_id=294, no_timestamps_token_id=295,
             timestamp_begin_id=296, pad_token_id=290, first_language_token_id=292)


@pytest.fixture(scope="module")
def small():
    from asr_finetune_tpu.models.configs import WhisperConfig as JConfig
    from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig
    jcfg, tcfg = JConfig(**SMALL), TConfig(**SMALL)
    jparams = JW.init_params(jax.random.PRNGKey(3), jcfg)
    jad = JL.init_adapters(jax.random.PRNGKey(4), jcfg,
                           JL.LoraConfig(rank=4, alpha=8.0), encoder=True)
    b_rng = np.random.default_rng(9)
    jad = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.02 * b_rng.standard_normal(a.shape), jnp.float32)
        if path[-1].key == "b" else a, jad)
    return jcfg, tcfg, JQ.quantize_tree_int8(jparams), jad


def _batch(seed, B=4, T=12, frames=300):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 289, (B, T)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), 290, np.int32)], axis=1)
    labels[0, -4:] = -100
    return {"mel": rng.standard_normal((B, frames, 16)).astype(np.float32),
            "decoder_input_ids": toks, "labels": labels}


def test_calibration_keeps_the_jax_classes(small, monkeypatch, jax_w8a8):
    """run.calibrate_outliers under ASR_TPU_FUSED_QKV=1 records exactly the
    classes the JAX trial's calibration records (its attn_impl "xla" makes
    the JAX gate yield): the (d, d) q/k/v class and no wide (d, 3d) one; so
    the fused train step's wide product takes the dynamic top-k form. The
    port's train step itself does take the fused path."""
    jcfg, tcfg, jq, jad = small
    _fused_env(monkeypatch, "1")
    monkeypatch.setenv("ASR_TPU_ATTN_IMPL", "xla")     # as the JAX trial sets it
    b = _batch(0)
    JQ.set_int8_compute(True)
    JQ.set_int8_outlier_cols(2)
    lcfg = JL.LoraConfig(rank=4, alpha=8.0)
    jstep = jax.jit(JTS.make_eval_loss_step(jcfg, JTS.TrainStepConfig(
        mode="peft", compute_dtype=jnp.float32, attn_impl="xla",
        decoder_attn_impl="xla", remat=False, lora=lcfg)))
    jidx = JQ.calibrate_int8_outliers(
        lambda: jax.block_until_ready(jstep({"params": jq, "adapters": jad},
                                            {k: jnp.asarray(v) for k, v in b.items()})),
        threshold=6.0, max_cols=4)
    monkeypatch.delenv("ASR_TPU_ATTN_IMPL")

    # the port's calibration reads audio: 47,840 samples give the 300 frames
    audio = np.random.default_rng(1).standard_normal((4, 47840)).astype(np.float32) * 0.1
    batch = {"audio": audio, "decoder_input_ids": b["decoder_input_ids"],
             "labels": b["labels"]}
    step_cfg = TTS.TrainStepConfig(
        mode="peft", compute_dtype=torch.float32, on_device_logmel=True, n_mels=16,
        lora=TL.LoraConfig(rank=4, alpha=8.0),
        quant=TQ.QuantConfig(matmul=True, outlier_cols=2))
    args = types.SimpleNamespace(int8_outlier_threshold=6.0, int8_outlier_cols=2)
    built = types.SimpleNamespace(cfg=tcfg, device=torch.device("cpu"))
    seen = []
    orig = TW._fuse_qkv_weights
    monkeypatch.setattr(TW, "_fuse_qkv_weights", lambda a: seen.append(1) or orig(a))
    idx = TR.calibrate_outliers(args, built, step_cfg, {"params": _carry(jq),
                                                        "adapters": _carry(jad)},
                                lambda shard: [batch])
    assert seen == []                       # the calibration forward stayed unfused
    assert sorted(idx) == sorted(jidx)
    assert (128, 384) not in idx and (128, 128) in idx
    assert step_cfg.quant.static_idx == idx
    # the train step's own forward does take the fused path
    TTS.loss_fn(_carry(jq), {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
                step_cfg, _carry(jad), TL.init_rank_mask(_carry(jad)))
    assert seen == [1]


# (loss rtol, grad_norm rtol, adapter atol / lr) per product form. Over the
# base dequantized, tests/test_torch_peft.py's tolerances. With W8A8 the
# frameworks' fp32 activations differ in the last bits, which now and then
# flips an int8 rounding (one step is 1/127 of a row's amax): the unfused
# path reads loss 2.5e-5, grad_norm 5.2e-5 and adapters 0.19·lr apart from
# the JAX step here, the fused one 1.7e-5, 6.0e-5 and 0.15·lr; the limits
# are 4x the unfused path's readings.
PEFT_STEP_TOL = {False: (1e-5, 1e-4, 0.02), True: (1e-4, 2.1e-4, 0.75)}


@pytest.mark.parametrize("matmul", [False, True])
def test_two_peft_steps_on_the_fused_path_match_jax(small, monkeypatch, jax_w8a8, matmul):
    """Two AdaLoRA steps over the int8 base, dequantized or with W8A8 (2
    dynamic outlier columns, no calibrated class), under
    ASR_TPU_FUSED_QKV=1: the port (remat on) against
    jax.jit(make_train_step(mode="peft")) (remat off), both on the fused
    path. Per step loss and grad_norm, after step 2 every adapter leaf, at
    PEFT_STEP_TOL."""
    jcfg, tcfg, jq, jad = small
    loss_rtol, gn_rtol, ad_atol = PEFT_STEP_TOL[matmul]
    _fused_env(monkeypatch, "1")
    JQ.set_int8_compute(matmul)
    JQ.set_int8_outlier_cols(2 if matmul else 0)
    lr, max_steps = 1e-3, 4
    lcfg = JL.LoraConfig(rank=4, alpha=8.0, dropout=0.0, adalora=True, delta_t=1)
    kw = dict(scheduler="linear", warmup_steps=1, weight_decay=0.01, max_grad_norm=1.0)
    tx = JO.make_optimizer(lr, max_steps, trainable_mask=JO.adapter_freeze_mask(jad, True),
                           **kw)
    jstep = jax.jit(JTS.make_train_step(jcfg, tx, JTS.TrainStepConfig(
        mode="peft", compute_dtype=jnp.float32, remat=False, lora=lcfg,
        max_steps=max_steps)))
    jstate = JTS.make_train_state(jq, tx, adapters=jad, adalora=True)

    tad = _carry(jad)
    opt = TO.make_optimizer(lr, max_steps, trainable_mask=TO.adapter_freeze_mask(tad, True),
                            **kw)
    tstate = TTS.make_train_state(_carry(jq), opt, tad, adalora=True)
    tstep = TTS.make_train_step(tcfg, opt, TTS.TrainStepConfig(
        mode="peft", compute_dtype=torch.float32, remat=True,
        lora=TL.LoraConfig(rank=4, alpha=8.0, dropout=0.0, adalora=True, delta_t=1),
        max_steps=max_steps,
        quant=TQ.QuantConfig(matmul=matmul, outlier_cols=2 if matmul else 0)))
    seen = []
    orig = TW._fuse_qkv_weights
    monkeypatch.setattr(TW, "_fuse_qkv_weights", lambda a: seen.append(1) or orig(a))
    for i in range(2):
        b = _batch(10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=loss_rtol)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=gn_rtol)
    assert len(seen) == 2
    ours, ref = TIO.params_to_numpy(tstate["adapters"]), JIO._flatten(jstate["adapters"])
    for k in ref:
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), atol=ad_atol * lr, rtol=1e-5,
                                   err_msg=k)


def test_peft_cli_with_fused_qkv_and_fused_decode(tmp_path, monkeypatch):
    """`cli.train --peft --load_in_8bit --adalora --int8_matmul` under
    ASR_TPU_FUSED_QKV=1 with the eval decode on the fused decode (forced on
    the CPU), on test-nano widened to 2 heads of 64: the steps run the fused
    encoder, the eval decode's merged mixed base takes the three projections
    (the JAX trial raises there), and the run reports a WER."""
    import csv
    import wave
    from asr_finetune_tpu_torch.cli import train as train_cli
    from asr_finetune_tpu_torch.evaluation import decode as TD
    rng = np.random.default_rng(0)
    folder = tmp_path / "af"
    folder.mkdir()
    with open(folder / "metadata.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "transcription"])
        for i, text in enumerate(["Wir sind nach Hause gegangen.", "Die Schule war klein.",
                                  "Mein Vater hat erzählt.", "Das Dorf lag am Fluss.",
                                  "Später kam die Arbeit.", "Ich weiß es nicht mehr."]):
            sig = rng.standard_normal(int(16000 * rng.uniform(0.5, 1.5))) * 0.1
            with wave.open(str(folder / f"u{i}.wav"), "wb") as wf:
                wf.setnchannels(1)
                wf.setsampwidth(2)
                wf.setframerate(16000)
                wf.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())
            w.writerow([f"u{i}.wav", text])
    monkeypatch.setattr(TR, "get_config", lambda name: TCFG)
    monkeypatch.setattr(TD, "_fused_default", lambda cfg, device: True)
    _fused_env(monkeypatch, "1")
    encodes = []
    orig_fuse, orig_decode = TW._fuse_qkv_weights, TW.decode_step_fused
    monkeypatch.setattr(TW, "_fuse_qkv_weights", lambda a: encodes.append(1) or orig_fuse(a))
    steps = []
    monkeypatch.setattr(TW, "decode_step_fused",
                        lambda *a, **k: steps.append(1) or orig_decode(*a, **k))
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        result = train_cli.main([
            "--model_type", "test-nano", "--device", "cpu", "--data_mode", "folder",
            "--dataset_name", str(folder), "--val_split", "0.34",
            "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "2",
            "--max_steps", "2", "--eval_steps", "2", "--save_steps", "2",
            "--logging_steps", "1", "--learning_rate", "1e-3",
            "--generation_max_length", "8", "--wer_weight", "0.7",
            "--output_dir", str(tmp_path / "out"), "--output_tag", "run",
            "--random_seed", "3", "--peft", "--load_in_8bit", "--adalora",
            "--int8_matmul", "--lora_rank", "4", "--lora_alpha", "8"])
    finally:
        torch.set_num_threads(n)
    assert result["final_step"] == 2
    # 2 steps (each forward once more in the remat recompute, which reuses
    # the step's wide weights) and one eval loss batch: 3 fused encodes
    assert len(encodes) == 3 and len(steps) > 0
    with open(tmp_path / "out" / "run" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    (ev,) = [r for r in recs if "eval_loss_wer" in r]
    assert np.isfinite(ev["eval_wer"]) and np.isfinite(ev["eval_loss"])

"""Port parity for full fine-tuning: the teacher-forced forward and three
train steps (AdamW, clipping, fused CE) of asr_finetune_tpu_torch against
the JAX package's jitted `make_train_step`, from the same weights (carried
by params_from_numpy) and the same numpy batch, at fp32 on the CPU; and the
port's own invariants: remat changes no gradient under any save-point
mode (full and PEFT), gradient accumulation
equals the full batch, attention through the kernel path equals plain
attention."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import WhisperConfig as JConfig
from asr_finetune_tpu.training import optim as JO
from asr_finetune_tpu.training import train_step as JTS
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig
from asr_finetune_tpu_torch.training import optim as TO
from asr_finetune_tpu_torch.training import train_step as TTS

# 64-dim heads, as every released Whisper; 150 encoder frames
SMALL = dict(vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
             encoder_heads=2, decoder_layers=2, decoder_heads=2, d_ff=256,
             max_source_positions=150, max_target_positions=32,
             eos_token_id=290, sot_token_id=291, translate_token_id=293,
             transcribe_token_id=294, no_timestamps_token_id=295,
             timestamp_begin_id=296, pad_token_id=290, first_language_token_id=292)
LR = 1e-4


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = JConfig(**SMALL), TConfig(**SMALL)
    jparams = JW.init_params(jax.random.PRNGKey(3), jcfg)
    flat = JIO._flatten(jparams)
    return jcfg, tcfg, jparams, flat


def _batch(seed, B=4, T=12, masked=True):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, 300, 16)).astype(np.float32)
    toks = rng.integers(0, 289, (B, T)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), 290, np.int32)], axis=1)
    if masked:
        labels[0, -4:] = -100
        labels[2, -1:] = -100
    return {"mel": mel, "decoder_input_ids": toks, "labels": labels}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _tparams(flat):
    return TIO.params_from_numpy(flat, "cpu")


def test_forward_matches_jax(small):
    jcfg, tcfg, jparams, flat = small
    b = _batch(0)
    ref = JW.forward(jparams, jnp.asarray(b["mel"]), jnp.asarray(b["decoder_input_ids"]),
                     jcfg, compute_dtype=jnp.float32, decoder_attn_impl="xla")
    tp = _tparams(flat)
    for impl in ("auto", "xla"):
        ours = TW.forward(tp, torch.from_numpy(b["mel"]),
                          torch.from_numpy(b["decoder_input_ids"]).long(), tcfg,
                          torch.float32, attn_impl=impl, decoder_attn_impl="xla")
        assert ours.dtype == torch.float32 and ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0,
                                   err_msg=impl)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 30)).astype(np.float32)
    labels = rng.integers(0, 30, (2, 9)).astype(np.int32)
    labels[1, 5:] = -100
    for ls in (0.0, 0.1):
        rl, rn = JW.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), ls)
        ol, on = TW.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), ls)
        assert int(on) == int(rn)
        np.testing.assert_allclose(float(ol), float(rl), rtol=1e-6)


def test_three_full_ft_steps_match_jax(small):
    """Loss per step rtol 1e-5, grad_norm rtol 1e-4, params after step 3
    within atol 0.02·lr + rtol 1e-5 (Adam divides tiny gradients by their
    own RMS, so their last bits move whole updates)."""
    jcfg, tcfg, jparams, flat = small
    kw = dict(scheduler="linear", warmup_steps=1, weight_decay=0.01, max_grad_norm=1.0)
    tx = JO.make_optimizer(LR, 10, **kw)
    jstep = jax.jit(JTS.make_train_step(jcfg, tx, JTS.TrainStepConfig(
        mode="full", compute_dtype=jnp.float32, remat=False)))
    jstate = JTS.make_train_state(jparams, tx)

    opt = TO.make_optimizer(LR, 10, **kw)
    tstate = TTS.make_train_state(_tparams(flat), opt)
    tstep = TTS.make_train_step(tcfg, opt, TTS.TrainStepConfig(
        compute_dtype=torch.float32, remat=True))
    for i in range(3):
        b = _batch(10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tm = tstep(tstate, _torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        assert int(tm["tokens"]) == int(jm["tokens"])
    assert tstate["step"] == int(jstate["step"]) == 3
    ref = JIO._flatten(jstate["params"])
    ours = TIO.params_to_numpy(tstate["params"])
    for k in ref:
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), atol=0.02 * LR,
                                   rtol=1e-5, err_msg=k)


def _grads(tcfg, flat, batch, **cfg):
    params = _tparams(flat)
    TTS.make_train_state(params, TO.make_optimizer(LR, 10))
    grads, m = TTS.compute_grads(params, batch, tcfg, TTS.TrainStepConfig(
        compute_dtype=torch.float32, **cfg))
    return [g.clone() for g in grads], m


def _peft_grads(tcfg, flat, batch, **cfg):
    """Adapter gradients of one PEFT step over the int8 base, every frozen
    product W8A8 (its plain version), lora dropout 0.1 at step 3; b drawn
    nonzero so that every adapter leaf has a gradient."""
    from asr_finetune_tpu_torch.ops import quant as TQ
    from asr_finetune_tpu_torch.training import lora as TL
    base = TQ.quantize_tree_int8(_tparams(flat))
    lcfg = TL.LoraConfig(rank=4, alpha=8.0, dropout=0.1)
    g = torch.Generator()
    g.manual_seed(5)
    ad = TL.init_adapters(g, tcfg, lcfg, encoder=True)
    for _, t in TO.leaves(ad):
        if t.dim() == 3 and not t.any():
            t.normal_(0.0, 0.02, generator=g)
    TTS.make_train_state(base, TO.make_optimizer(LR, 10), ad)
    grads, m = TTS.compute_grads(base, batch, tcfg, TTS.TrainStepConfig(
        mode="peft", compute_dtype=torch.float32, lora=lcfg,
        quant=TQ.QuantConfig(matmul=True), **cfg), ad, step=3)
    return [g.clone() for g in grads], m


@pytest.mark.parametrize("mode", ["mid", "enc", "enc+dec"])
@pytest.mark.parametrize("kind", ["full", "peft"])
def test_remat_changes_no_gradient(small, monkeypatch, kind, mode):
    """Remat under each ASR_TPU_REMAT_SAVE against no remat: the same loss
    and the same gradient bits (the autograd graph is the same; only what
    the backward recomputes differs)."""
    *_, tcfg, _, flat = small
    b = _torch_batch(_batch(20))
    grads = _grads if kind == "full" else _peft_grads
    g0, m0 = grads(tcfg, flat, b, remat=False)
    monkeypatch.setenv("ASR_TPU_REMAT_SAVE", mode)
    g1, m1 = grads(tcfg, flat, b, remat=True)
    assert float(m0["loss"]) == float(m1["loss"])
    assert any(bool(g.any()) for g in g1)
    for a, c in zip(g0, g1):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_grad_accum_matches_full_batch(small):
    """accum_steps=2 over (2, 2, ...) microbatches: the averaged gradients
    equal the full batch's (equal token counts per microbatch), atol 1e-5
    as tests/test_train_step.py."""
    *_, tcfg, _, flat = small
    b = _batch(21, masked=False)
    full, mf = _grads(tcfg, flat, _torch_batch(b), remat=False)
    micro = {k: torch.from_numpy(v.reshape((2, 2) + v.shape[1:])) for k, v in b.items()}
    acc, ma = _grads(tcfg, flat, micro, remat=False, accum_steps=2)
    np.testing.assert_allclose(float(ma["loss"]), float(mf["loss"]), rtol=1e-6)
    assert int(ma["tokens"]) == int(mf["tokens"])
    for a, c in zip(full, acc):
        np.testing.assert_allclose(c.numpy(), a.numpy(), atol=1e-5)


def test_kernel_path_gradients_equal_plain_attention(small, monkeypatch):
    """attn_impl "auto" (the encoder-attention Function, its plain backward
    on CPU) against "xla" (plain softmax attention under autograd); the
    cross-attention, which the decoder promotes to "auto", is held plain
    too in the reference run."""
    from asr_finetune_tpu_torch.ops import attention as A
    *_, tcfg, _, flat = small
    b = _torch_batch(_batch(22))
    ga, ma = _grads(tcfg, flat, b, remat=False, attn_impl="auto")
    monkeypatch.setattr(A, "encoder_attention",
                        lambda q, k, v: A.xla_attention(q, k, v))
    gx, mx = _grads(tcfg, flat, b, remat=False, attn_impl="xla",
                    decoder_attn_impl="xla")
    np.testing.assert_allclose(float(ma["loss"]), float(mx["loss"]), rtol=1e-6)
    for a, c in zip(ga, gx):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-6, rtol=1e-4)


def test_fused_ce_step_equals_full_logits_step(small):
    """The chunked fused CE (the default) and cross_entropy of the full
    (B, T, V) logits give the same loss and gradients."""
    *_, tcfg, _, flat = small
    b = _torch_batch(_batch(23))
    gf, mf = _grads(tcfg, flat, b, remat=False)
    gl, ml = _grads(tcfg, flat, b, remat=False, fused_ce=False)
    np.testing.assert_allclose(float(mf["loss"]), float(ml["loss"]), rtol=1e-6)
    for a, c in zip(gf, gl):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-6, rtol=1e-4)


def test_train_state_needs_fp32_masters():
    params = TW.init_params(dataclasses.replace(TConfig(**SMALL), encoder_layers=1,
                                                decoder_layers=1))
    params["decoder"]["embed"] = params["decoder"]["embed"].bfloat16()
    with pytest.raises(TypeError, match="fp32 master"):
        TTS.make_train_state(params, TO.make_optimizer(LR, 10))

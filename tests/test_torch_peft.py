"""Port parity for PEFT (LoRA / AdaLoRA adapters over a frozen int8 or bf16
base): the forward with adapters and three train steps of
asr_finetune_tpu_torch against the JAX package's `W.forward(...,
adapters=...)` and jitted `make_train_step(mode="peft")`, from the same
base and adapters (carried by params_from_numpy) and the same numpy batches,
at fp32 compute on the CPU; and the port's own lora dropout
(tests/test_torch_peft_cli.py runs `cli.train --peft` end to end)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import WhisperConfig as JConfig
from asr_finetune_tpu.ops import quant as JQ
from asr_finetune_tpu.training import lora as JL
from asr_finetune_tpu.training import optim as JO
from asr_finetune_tpu.training import train_step as JTS
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig
from asr_finetune_tpu_torch.ops import quant as TQ
from asr_finetune_tpu_torch.training import lora as TL
from asr_finetune_tpu_torch.training import optim as TO
from asr_finetune_tpu_torch.training import train_step as TTS

# tests/test_torch_train_step.py's SMALL: 64-dim heads, 150 encoder frames
SMALL = dict(vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
             encoder_heads=2, decoder_layers=2, decoder_heads=2, d_ff=256,
             max_source_positions=150, max_target_positions=32,
             eos_token_id=290, sot_token_id=291, translate_token_id=293,
             transcribe_token_id=294, no_timestamps_token_id=295,
             timestamp_begin_id=296, pad_token_id=290, first_language_token_id=292)
LR = 1e-3
MAX_STEPS = 4      # tinit 0, tfinal 3: AdaLoRA's budget anneals within 3 steps


def _batch(seed, B=4, T=12):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, 300, 16)).astype(np.float32)
    toks = rng.integers(0, 289, (B, T)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), 290, np.int32)], axis=1)
    labels[0, -4:] = -100
    return {"mel": mel, "decoder_input_ids": toks, "labels": labels}


def _carry(tree, dtype=torch.float32):
    """A JAX tree into the port (a bf16 base is carried as its fp32 values
    and cast: numpy has no bf16 torch can read)."""
    flat = {k: (v.astype(np.float32) if v.dtype.name == "bfloat16" else v)
            for k, v in JIO._flatten(tree).items()}
    return TIO.params_from_numpy(flat, "cpu", dtype)


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = JConfig(**SMALL), TConfig(**SMALL)
    jparams = JW.init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jparams


def _adapters(jcfg, lcfg):
    """JAX adapters with b moved off zero (so every term of the delta and
    its gradients is live), carried into the port."""
    jad = JL.init_adapters(jax.random.PRNGKey(4), jcfg, lcfg, encoder=True)
    b_rng = np.random.default_rng(9)
    jad = jax.tree_util.tree_map_with_path(
        lambda p, a: a + jnp.asarray(0.02 * b_rng.standard_normal(a.shape), jnp.float32)
        if p[-1].key == "b" else a, jad)
    return jad, _carry(jad)


def _base(jparams, kind):
    """(JAX base, port base): int8 per output channel, or every leaf bf16."""
    if kind == "int8":
        jq = JQ.quantize_tree_int8(jparams)
        return jq, _carry(jq)
    return (jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams),
            _carry(jparams, torch.bfloat16))


@pytest.fixture
def jax_int8_compute():
    """The JAX module's process-wide W8A8 switch, off again after the test."""
    yield JQ
    JQ.set_int8_compute(False)
    JQ.set_int8_outlier_cols(0)


@pytest.mark.parametrize("base,matmul", [("int8", False), ("int8", True), ("bf16", False)])
def test_peft_forward_matches_jax(small, jax_int8_compute, base, matmul):
    """The forward with encoder + decoder adapters over the int8 base
    (dequantized, or W8A8 with 2 dynamic outlier columns) and over the bf16
    base, fp32 compute, against JAX `W.forward(..., adapters=...)` jitted.
    Logits within 1e-4 (the full-model test's tolerance); W8A8 within 2e-2:
    the two frameworks' fp32 activations differ in the last bits, which
    flips an int8 rounding of an activation now and then (one step is
    1/127 of its row's amax), and those flips reach the logits."""
    jcfg, tcfg, jparams = small
    jbase, tbase = _base(jparams, base)
    jad, tad = _adapters(jcfg, JL.LoraConfig(rank=4, alpha=8.0, dropout=0.0))
    b = _batch(0)
    JQ.set_int8_compute(matmul)
    JQ.set_int8_outlier_cols(2 if matmul else 0)
    ref = jax.jit(lambda p, a, m, t: JW.forward(
        p, m, t, jcfg, adapters=a, compute_dtype=jnp.float32,
        decoder_attn_impl="xla"))(jbase, jad, jnp.asarray(b["mel"]),
                                  jnp.asarray(b["decoder_input_ids"]))
    quant = TQ.QuantConfig(matmul=True, outlier_cols=2) if matmul else None
    ours = TW.forward(tbase, torch.from_numpy(b["mel"]),
                      torch.from_numpy(b["decoder_input_ids"]).long(), tcfg,
                      torch.float32, decoder_attn_impl="xla", adapters=tad, quant=quant)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-2 if matmul else 1e-4)


VARIANTS = {   # base, AdaLoRA
    "adalora-int8": ("int8", True),
    "adalora-bf16": ("bf16", True),
    "lora-int8": ("int8", False),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_peft_steps_match_jax(small, variant):
    """Three PEFT steps (AdaLoRA: delta_t 1, budget annealed over 4 steps;
    dropout 0) against jax.jit(make_train_step(mode="peft")), fp32 compute,
    remat on in the port and off in JAX. Per step: loss and orth_reg rtol
    1e-5, grad_norm rtol 1e-4; after step 3: every adapter leaf within
    0.02·lr + rtol 1e-5 (Adam divides tiny gradients by their own RMS, as
    the full-model test says), sensitivity within rtol 2e-3 + 1e-9 (|p·g|
    of those gradients), rank masks equal and not all ones. Plain LoRA:
    scaling and e never move (JAX tests/test_lora.py:111)."""
    jcfg, tcfg, jparams = small
    base, adalora = VARIANTS[variant]
    lcfg = JL.LoraConfig(rank=4, alpha=8.0, dropout=0.0, adalora=adalora, delta_t=1)
    tlcfg = TL.LoraConfig(rank=4, alpha=8.0, dropout=0.0, adalora=adalora, delta_t=1)
    jbase, tbase = _base(jparams, base)
    jad, tad = _adapters(jcfg, lcfg)
    kw = dict(scheduler="linear", warmup_steps=1, weight_decay=0.01, max_grad_norm=1.0)

    tx = JO.make_optimizer(LR, MAX_STEPS, trainable_mask=JO.adapter_freeze_mask(jad, adalora),
                           **kw)
    jstep = jax.jit(JTS.make_train_step(jcfg, tx, JTS.TrainStepConfig(
        mode="peft", compute_dtype=jnp.float32, remat=False, lora=lcfg,
        max_steps=MAX_STEPS)))
    jstate = JTS.make_train_state(jbase, tx, adapters=jad, adalora=adalora)

    opt = TO.make_optimizer(LR, MAX_STEPS, trainable_mask=TO.adapter_freeze_mask(tad, adalora),
                            **kw)
    tstate = TTS.make_train_state(tbase, opt, tad, adalora=adalora)
    tstep = TTS.make_train_step(tcfg, opt, TTS.TrainStepConfig(
        mode="peft", compute_dtype=torch.float32, remat=True, lora=tlcfg,
        max_steps=MAX_STEPS))
    base_before = {k: v.copy() for k, v in TIO.params_to_numpy(tbase).items()}
    ad_before = TIO.params_to_numpy(tad)
    for i in range(3):
        b = _batch(10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert ("orth_reg" in tm) == ("orth_reg" in jm) == adalora
        if adalora:
            np.testing.assert_allclose(float(tm["orth_reg"]), float(jm["orth_reg"]), rtol=1e-5)
    assert tstate["step"] == 3
    ours, ref = TIO.params_to_numpy(tstate["adapters"]), JIO._flatten(jstate["adapters"])
    for k in ref:
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), atol=0.02 * LR, rtol=1e-5,
                                   err_msg=k)
    for k, v in TIO.params_to_numpy(tstate["params"]).items():
        np.testing.assert_array_equal(v, base_before[k], err_msg=k)   # the base is frozen
    if adalora:
        sens, jsens = TIO.params_to_numpy(tstate["sensitivity"]), JIO._flatten(jstate["sensitivity"])
        for k in jsens:
            np.testing.assert_allclose(sens[k], jsens[k], rtol=2e-3, atol=1e-9, err_msg=k)
        mask, jmask = TIO.params_to_numpy(tstate["rank_mask"]), JIO._flatten(jstate["rank_mask"])
        assert set(mask) == set(jmask)
        for k in jmask:
            np.testing.assert_array_equal(mask[k], jmask[k], err_msg=k)
        assert min(float(m.min()) for m in mask.values()) == 0.0   # the masks moved
    else:
        for k in ref:
            if k.endswith("/scaling") or k.endswith("/e"):
                np.testing.assert_array_equal(ours[k], ad_before[k], err_msg=k)


def test_lora_dropout_mask_law_and_repeats():
    """The port's lora dropout: keep rate 1 - p and the 1/(1-p) scaling of
    the kept entries; the same seed, step and site give the same mask, and
    another step or site another one (the JAX masks come from the backend's
    own bit generator, so the law is what the two share)."""
    x = torch.ones((64, 1024))
    p = 0.25
    d = TW.LoraDropout(p, seed=3, step=5)
    y = d(x, "enc/0/q")
    keep = (y != 0).float().mean().item()
    assert abs(keep - (1 - p)) < 0.01
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - p)))
    assert torch.equal(y, TW.LoraDropout(p, seed=3, step=5)(x, "enc/0/q"))
    assert not torch.equal(y, TW.LoraDropout(p, seed=3, step=6)(x, "enc/0/q"))
    assert not torch.equal(y, d(x, "enc/0/v"))
    assert torch.equal(TW.LoraDropout(0.0, seed=3)(x, "s"), x)


def test_peft_dropout_is_the_same_in_the_remat_recompute(small):
    """With lora dropout on, remat's recompute draws the forward's masks
    again: gradients with remat equal those without, exactly."""
    jcfg, tcfg, jparams = small
    _, tbase = _base(jparams, "int8")
    lcfg = TL.LoraConfig(rank=4, alpha=8.0, dropout=0.3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    out = []
    for remat in (False, True):
        _, tad = _adapters(jcfg, JL.LoraConfig(rank=4, alpha=8.0))
        TTS.make_train_state(tbase, TO.make_optimizer(LR, 4), tad)
        grads, m = TTS.compute_grads(tbase, batch, tcfg, TTS.TrainStepConfig(
            mode="peft", compute_dtype=torch.float32, remat=remat, lora=lcfg, seed=1),
            tad, step=2)
        out.append(([g.clone() for g in grads], float(m["loss"])))
    assert out[0][1] == out[1][1]
    for a, c in zip(out[0][0], out[1][0]):
        torch.testing.assert_close(a, c, rtol=0, atol=0)

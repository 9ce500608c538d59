"""SpecAugment in the port (asr_finetune_tpu_torch/ops/spec_augment.py and
the train step's use of it) against the JAX package's
(asr_finetune_tpu/ops/spec_augment.py): the masking on the JAX masks, the
draw's law and its streams, a train step with it, and the eval loss
without it. Two ranks against one process: tests/test_torch_parallel.py
::test_spec_augment_two_ranks_equal_one_process."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.ops import spec_augment as JSA
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import WhisperConfig
from asr_finetune_tpu_torch.ops import spec_augment as TSA
from asr_finetune_tpu_torch.training import optim as TO
from asr_finetune_tpu_torch.training import train_step as TTS

SMALL = dict(vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
             encoder_heads=2, decoder_layers=2, decoder_heads=2, d_ff=256,
             max_source_positions=150, max_target_positions=32,
             eos_token_id=290, sot_token_id=291, translate_token_id=293,
             transcribe_token_id=294, no_timestamps_token_id=295,
             timestamp_begin_id=296, pad_token_id=290, first_language_token_id=292)


@pytest.mark.parametrize("mask_value", [None, -1.5])
def test_apply_masks_matches_jax_on_its_masks(mask_value):
    """The JAX spec_augment draws its masks with `_axis_mask` from the two
    halves of its key: the port's apply_masks on those masks gives its
    output, atol 1e-6 (fp32; the mean's sums in another order)."""
    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((3, 400, 80)) - 0.4).astype(np.float32)
    cfg = JSA.SpecAugmentConfig(mask_value=mask_value)
    B, T, F = mel.shape
    for seed in (7, 8):
        key = jax.random.PRNGKey(seed)
        kf, kt = jax.random.split(key)
        fm = JSA._axis_mask(kf, F, min(cfg.freq_mask_param, F), cfg.n_freq_masks, B)
        tm = JSA._axis_mask(kt, T, min(cfg.time_mask_param, T), cfg.n_time_masks, B)
        ref = np.asarray(JSA.spec_augment(key, jnp.asarray(mel), cfg))
        ours = TSA.apply_masks(torch.from_numpy(mel), torch.from_numpy(np.array(fm)),
                               torch.from_numpy(np.array(tm)), mask_value)
        assert (ref != mel).any()
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("length,param", [(80, 27), (3000, 100), (16, 27), (128, 27)])
def test_draw_keeps_the_jax_law(length, param):
    """widths U{0..min(param, L)}, starts U{0..max(L - w, 1) - 1}: every
    width value drawn, none out of range, the starts uniform below their
    bound (the mean of (start + 1/2) / bound within 0.01 of 1/2)."""
    g = torch.Generator()
    g.manual_seed(1)
    max_w = min(param, length)
    w, s = TSA.draw_spans(g, 4000, length, max_w, 2)
    assert w.shape == s.shape == (4000, 2) and w.dtype == s.dtype == torch.int64
    assert sorted(w.unique().tolist()) == list(range(max_w + 1))
    high = (length - w).clamp(min=1)
    assert bool((s >= 0).all()) and bool((s < high).all())
    assert abs(float(((s.double() + 0.5) / high).mean()) - 0.5) < 0.01
    mask = TSA.spans_to_mask(w, s, length)
    covered = torch.zeros_like(mask)
    pos = torch.arange(length)
    for j in range(2):
        covered |= (pos >= s[:, j:j + 1]) & (pos < (s + w)[:, j:j + 1])
    assert torch.equal(mask, covered)


def test_streams_repeat_and_differ():
    """The same (seed, stream) draws the same masks; another stream or
    another seed other masks; a rank's rows of the global draw are the
    one-process draw's rows."""
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 300, 16)).astype(np.float32))
    a = TTS.spec_augment_stream(0, 3)(mel)
    assert torch.equal(a, TTS.spec_augment_stream(0, 3)(mel))
    assert not torch.equal(a, TTS.spec_augment_stream(0, 4)(mel))
    assert not torch.equal(a, TTS.spec_augment_stream(1, 3)(mel))
    halves = [TTS.spec_augment_stream(0, 3, row0=r, rows=4)(mel[r: r + 2]) for r in (0, 2)]
    assert torch.equal(torch.cat(halves), a)
    fmask, tmask = TSA.draw_masks(TW.site_generator(0, 3, "spec_augment", "cpu"), 4, 300, 16)
    assert fmask.shape == (4, 16) and tmask.shape == (4, 300)
    assert torch.equal(TSA.apply_masks(mel, fmask, tmask), a)


@pytest.fixture(scope="module")
def small():
    cfg = WhisperConfig(**SMALL)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 289, (4, 12))
    labels = np.concatenate([toks[:, 1:], np.full((4, 1), 290)], axis=1)
    batch = {"mel": torch.from_numpy(rng.standard_normal((4, 300, 16)).astype(np.float32)),
             "decoder_input_ids": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    return cfg, batch


def _one_step(small, **cfg):
    mcfg, batch = small
    params = TW.init_params(mcfg, seed=0)
    opt = TO.make_optimizer(1e-3, 10)
    state = TTS.make_train_state(params, opt)
    step = TTS.make_train_step(mcfg, opt, TTS.TrainStepConfig(
        compute_dtype=torch.float32, remat=False, **cfg))
    m = step(state, batch)
    return float(m["loss"]), [p.detach().clone() for _, p in TO.leaves(state["params"])]


def test_spec_augment_step_replays_and_varies_with_the_seed(small):
    """A full fine-tuning step with SpecAugment equals its replay bit for
    bit; another seed (other masks) gives another loss and other weights,
    and so does the step without SpecAugment (the JAX
    tests/test_round3_fixes.py::test_spec_augment_rng_seed_varies)."""
    l0, p0 = _one_step(small, spec_augment=True, seed=0)
    l0b, p0b = _one_step(small, spec_augment=True, seed=0)
    l7, p7 = _one_step(small, spec_augment=True, seed=7)
    ln, pn = _one_step(small, spec_augment=False, seed=0)
    assert l0 == l0b and all(torch.equal(a, b) for a, b in zip(p0, p0b))
    for other, po in ((l7, p7), (ln, pn)):
        assert other != l0
        assert max(float((a - b).abs().max()) for a, b in zip(p0, po)) > 0


def test_eval_loss_never_masks(small):
    """The eval loss is the same with and without --spec_augment (the JAX
    eval step passes no rng, so its loss applies no masks)."""
    mcfg, batch = small
    state = {"params": TW.init_params(mcfg, seed=0)}
    losses = [float(TTS.make_eval_loss_step(mcfg, TTS.TrainStepConfig(
        compute_dtype=torch.float32, spec_augment=on))(state, batch)["loss"])
        for on in (False, True)]
    assert losses[0] == losses[1]

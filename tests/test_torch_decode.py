"""Port parity: asr_finetune_tpu_torch greedy decoding and the transcription
CLI against the JAX package, at fp32 on CPU.

Greedy tokens must be EQUAL to JAX greedy_decode(fused=True) — the Pallas
kernels in interpret mode — through the port's fused path (kernel wrappers,
plain versions on CPU) and its plain decode step, with and without the
suppress lists and the timestamp grammar. The CLI test runs both packages'
transcribe CLIs over one native checkpoint written by the JAX package."""
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.evaluation import decode as JD
from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import WhisperConfig as JConfig
from asr_finetune_tpu_torch.evaluation import decode as TD
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig

# test_decoder_fused.py's TINY dims; specials below 12 timestamp tokens
# (ids 601..612), as in Whisper's layout
TINY = dict(vocab_size=613, num_mel_bins=16, d_model=256, encoder_layers=2,
            encoder_heads=4, decoder_layers=2, decoder_heads=4, d_ff=1024,
            max_source_positions=48, max_target_positions=64, eos_token_id=590,
            sot_token_id=591, translate_token_id=592, transcribe_token_id=593,
            no_timestamps_token_id=600, timestamp_begin_id=601, pad_token_id=590,
            first_language_token_id=592)
MAXLEN = 20
NO_TS, TS_BEGIN = 600, 601
FORCED = [591, 592, 593]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = JConfig(**TINY), TConfig(**TINY)
    jparams = JW.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = TIO.params_from_numpy(JIO._flatten(jparams), "cpu")
    mel = np.random.default_rng(2).standard_normal(
        (3, 2 * jcfg.max_source_positions, jcfg.num_mel_bins)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, mel


def _variants(jcfg, jparams, mel):
    """Decode options per variant; the suppress lists ban the first free
    token and the one after it in the unsuppressed JAX stream, so they
    change what is decoded."""
    t, _ = JD.greedy_decode(jparams, jnp.asarray(mel), jcfg, FORCED, MAXLEN,
                            compute_dtype=jnp.float32, fused=True)
    t = np.asarray(t)
    n = len(FORCED)
    return {
        "plain": {},
        "suppress": dict(suppress_tokens=[int(t[0, n + 1])],
                         begin_suppress_tokens=[int(t[0, n]), int(t[1, n])]),
        "timestamps": dict(timestamp_begin=TS_BEGIN, no_timestamps_id=NO_TS),
    }


@pytest.fixture(scope="module")
def jax_streams(setup):
    jcfg, _, jparams, _, mel = setup
    out = {}
    for name, kw in _variants(jcfg, jparams, mel).items():
        t, l = JD.greedy_decode(jparams, jnp.asarray(mel), jcfg, FORCED, MAXLEN,
                                compute_dtype=jnp.float32, fused=True, **kw)
        out[name] = (kw, np.asarray(t), np.asarray(l))
    return out


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("variant", ["plain", "suppress", "timestamps"])
def test_greedy_tokens_equal_jax(setup, jax_streams, variant, fused):
    _, tcfg, _, tparams, mel = setup
    kw, t_ref, l_ref = jax_streams[variant]
    tokens, lengths = TD.greedy_decode(tparams, torch.from_numpy(mel), tcfg,
                                       FORCED, MAXLEN,
                                       compute_dtype=torch.float32,
                                       fused=fused, **kw)
    np.testing.assert_array_equal(tokens.numpy(), t_ref)
    np.testing.assert_array_equal(lengths.numpy(), l_ref)
    if variant == "timestamps":   # the grammar really acted
        assert (tokens[:, len(FORCED)] >= TS_BEGIN).all()


def test_pending_decode_options_raise(setup):
    """Beams, int8 cross-KV and int8 decoder weights are served
    (tests/test_torch_beam.py, tests/test_torch_int8.py hold them against
    JAX), a fused beam decode wider than the Pallas kernels' 8 included;
    nothing of these options raises any more."""
    _, tcfg, _, tparams, mel = setup
    for kw in (dict(num_beams=4), dict(kv_int8=True), dict(w_int8=True),
               dict(num_beams=2, kv_int8=True, w_int8=True)):
        assert callable(TD.make_decode_fn(tcfg, FORCED, **kw))
    tokens, lengths = TD.make_decode_fn(tcfg, FORCED, 6, num_beams=9,
                                        compute_dtype=torch.float32, fused=True)(
        tparams, torch.from_numpy(mel[:1]))
    assert tokens.shape == (1, 6) and lengths.shape == (1,)


def test_fused_needs_64_dim_heads(setup):
    _, _, _, tparams, mel = setup
    cfg = TConfig(**{**TINY, "decoder_heads": 2})
    with pytest.raises(ValueError, match="64-dim heads"):
        TD.greedy_decode(tparams, torch.from_numpy(mel), cfg, FORCED, 8,
                         compute_dtype=torch.float32, fused=True)
    # and the default rule never picks the fused path off CUDA
    assert not TD._fused_default(TConfig(**TINY), torch.device("cpu"))


def test_fused_default_on_any_cuda_device(monkeypatch):
    """The fused kernels are the default on a CUDA device, however many
    cards the host has; the rule reads only the device and the head dim."""
    cfg = TConfig(**TINY)
    for n_cards in (1, 2, 8):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n_cards: n)
        for dev in ("cuda", "cuda:0", "cuda:1"):
            assert TD._fused_default(cfg, torch.device(dev))
    assert not TD._fused_default(TConfig(**{**TINY, "decoder_heads": 2}),
                                 torch.device("cuda"))


@pytest.mark.parametrize("fused", [True, False])
def test_weights_cast_once_change_no_token(setup, fused):
    """bf16 greedy decode: weights cast once up front (run.build_model with
    --bf16) give the tokens of fp32 weights cast at every use."""
    _, tcfg, _, tparams, mel = setup
    fresh = TIO.params_from_numpy(TIO.params_to_numpy(tparams), "cpu")
    cast = TW.cast_matmul_weights_(fresh, torch.bfloat16)
    kw = dict(compute_dtype=torch.bfloat16, fused=fused,
              timestamp_begin=TS_BEGIN, no_timestamps_id=NO_TS)
    ref = TD.greedy_decode(tparams, torch.from_numpy(mel), tcfg, FORCED, MAXLEN, **kw)
    out = TD.greedy_decode(cast, torch.from_numpy(mel), tcfg, FORCED, MAXLEN, **kw)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), r.numpy())


def _write_wav(path, samples):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(samples.astype("<i2").tobytes())


def test_transcribe_cli_matches_jax(tmp_path):
    """wav + long wav (> 30 s, two windows) + h5 through both CLIs, fp32."""
    from asr_finetune_tpu.cli import transcribe as jax_cli
    from asr_finetune_tpu.data.hdf5 import make_synthetic_dataset
    from asr_finetune_tpu.models.configs import get_config
    from asr_finetune_tpu_torch.cli import transcribe as torch_cli

    cfg = get_config("test-nano")
    JIO.save_params(str(tmp_path / "ckpt"),
                    JW.init_params(jax.random.PRNGKey(3), cfg), cfg)
    # whisper's suppress lists, read from the checkpoint by both build_models
    (tmp_path / "ckpt" / "generation_config.json").write_text(
        '{"suppress_tokens": [32, 101], "begin_suppress_tokens": [256]}')
    rng = np.random.default_rng(4)
    _write_wav(tmp_path / "a.wav", rng.standard_normal(16000) * 3000)
    _write_wav(tmp_path / "long.wav", rng.standard_normal(16000 * 33) * 3000)
    make_synthetic_dataset(str(tmp_path / "d.h5"), n=3, seed=1,
                           min_sec=0.5, max_sec=1.0)
    args = ["--inputs", str(tmp_path / "a.wav"), str(tmp_path / "long.wav"),
            str(tmp_path / "d.h5"), "--model_path", str(tmp_path / "ckpt"),
            "--per_device_eval_batch_size", "2", "--generation_max_length", "10",
            "--no-bf16"]
    ref = jax_cli.main(args)
    ours = torch_cli.main(args + ["--device", "cpu"])
    assert len(ours) == 5
    assert ours == ref

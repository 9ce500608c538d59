"""The port's real-checkpoint parity gauntlet (cli/verify_parity.py) on the
CPU: every stage passes on the tiny random-init HF checkpoint of
tests/test_cli_verify_parity.py, its greedy and beam token streams equal
those of the JAX gauntlet on the same directory, its helpers equal JAX's,
and without transformers it raises ImportError naming it."""
import sys

import numpy as np
import pytest

from asr_finetune_tpu.cli import verify_parity as jvp
from asr_finetune_tpu_torch.cli import verify_parity as tvp

STAGES = ("convert", "f64_logits", "frontend", "greedy", "beam", "wer_smoke")


@pytest.fixture(scope="module")
def tiny_hf_dir(tmp_path_factory):
    import torch
    from transformers import (WhisperConfig, WhisperFeatureExtractor,
                              WhisperForConditionalGeneration)

    d = tmp_path_factory.mktemp("tiny_hf_ckpt")
    hf_cfg = WhisperConfig(
        vocab_size=120, num_mel_bins=80, d_model=64, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=1500, max_target_positions=64, pad_token_id=0,
        bos_token_id=1, eos_token_id=2, decoder_start_token_id=3,
        suppress_tokens=[], begin_suppress_tokens=[],
    )
    torch.manual_seed(0)
    m = WhisperForConditionalGeneration(hf_cfg).eval()
    m.generation_config.suppress_tokens = None
    m.generation_config.begin_suppress_tokens = None
    m.generation_config.forced_decoder_ids = None
    m.generation_config.no_timestamps_token_id = 110
    m.save_pretrained(d)
    WhisperFeatureExtractor(feature_size=80).save_pretrained(d)
    return str(d)


def _recording(module, monkeypatch):
    """Record every (ours_full, hf_cont) pair the gauntlet compares."""
    seen = []
    real = module._token_parity

    def record(ours_full, hf_cont, n_forced, eot):
        seen.append((np.asarray(ours_full).copy(), np.asarray(hf_cont).copy()))
        return real(ours_full, hf_cont, n_forced, eot)

    monkeypatch.setattr(module, "_token_parity", record)
    return seen


def test_gauntlet_passes_and_streams_equal_jax(tiny_hf_dir, capsys, monkeypatch):
    argv = ["--hf_dir", tiny_hf_dir, "--rows", "2", "--max_length", "12", "--beams", "2"]
    ours = _recording(tvp, monkeypatch)
    rc = tvp.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for stage in STAGES:
        assert f"[PASS] {stage}" in out, out
    assert '"failed": 0' in out.splitlines()[-1]
    ref = _recording(jvp, monkeypatch)
    assert jvp.main(argv + ["--skip_f64"]) == 0, capsys.readouterr().out
    assert len(ours) == len(ref) == 2                   # greedy, beam
    for (o_full, o_hf), (r_full, r_hf) in zip(ours, ref):
        np.testing.assert_array_equal(o_full, r_full)
        np.testing.assert_array_equal(o_hf, r_hf)
        assert o_full.shape[1] > 1


def test_converted_checkpoint_is_row_major(tiny_hf_dir):
    """HF's (out, in) weights convert to (in, out) views; the port's tree
    holds them row-major, as the card's kernels require of their operands
    (before, a greedy decode of an HF directory on the card raised
    "kernel operands must be contiguous")."""
    from asr_finetune_tpu_torch.models.convert_hf import load_pretrained
    from asr_finetune_tpu_torch.training.optim import leaves
    params, _ = load_pretrained(tiny_hf_dir)
    assert [k for k, v in leaves(params) if not v.is_contiguous()] == []
    assert params["encoder"]["layers"]["attn"]["q"]["w"].shape == (2, 64, 64)


def test_synth_audio_equals_jax():
    for n in (1, 3):
        np.testing.assert_array_equal(tvp._synth_audio(n), jvp._synth_audio(n))
    np.testing.assert_array_equal(tvp._synth_audio(2, seconds=1.5, sr=8000),
                                  jvp._synth_audio(2, seconds=1.5, sr=8000))


def test_token_parity_equals_jax():
    rng = np.random.default_rng(0)
    eot = 2
    for _ in range(40):
        rows, n_forced = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        hf = rng.integers(0, 6, (rows, int(rng.integers(1, 10))))
        ours = np.concatenate([np.full((rows, n_forced), 9),
                               np.where(rng.random(hf.shape) < 0.15, 5, hf)], 1)
        ours = ours[:, : n_forced + int(rng.integers(0, hf.shape[1] + 2))]
        assert tvp._token_parity(ours, hf, n_forced, eot) == \
            jvp._token_parity(ours, hf, n_forced, eot)


def test_raises_without_transformers(monkeypatch, tmp_path):
    for name in [m for m in sys.modules if m == "transformers" or m.startswith("transformers.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "transformers", None)   # `import transformers` raises
    with pytest.raises(ImportError, match="needs transformers"):
        tvp.main(["--hf_dir", str(tmp_path), "--device", "cpu"])


class _NoWords:
    """A tokenizer whose transcripts hold no word."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def batch_decode(self, rows):
        return ["" for _ in rows]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_wer_stage_undefined_without_words(tiny_hf_dir, monkeypatch, capsys, package):
    """Where HF's greedy transcripts hold no word the WER is undefined: the
    gauntlet raises ValueError in the port as in JAX, and passes nothing."""
    module, tok_module, extra = (
        (tvp, "asr_finetune_tpu_torch.models.tokenizer", ["--device", "cpu"])
        if package == "port" else (jvp, "asr_finetune_tpu.models.tokenizer", []))
    tok = __import__(tok_module, fromlist=["load_tokenizer"])
    real = tok.load_tokenizer
    monkeypatch.setattr(tok, "load_tokenizer", lambda *a, **k: _NoWords(real(*a, **k)))
    with pytest.raises(ValueError, match="no reference words"):
        module.main(["--hf_dir", tiny_hf_dir, "--rows", "1", "--max_length", "6",
                     "--beams", "2", "--skip_f64", *extra])
    assert "wer_smoke" not in capsys.readouterr().out

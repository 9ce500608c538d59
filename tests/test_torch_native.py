"""The port's host C++ path (utils/native_ext, csrc/asr_native.cpp) against
the JAX package's native_ext and the plain Python versions, exactly: the
edit distance, corpus WER and batch assembly, the port's WER and its
collator's audio; where the library is built; and that a failed build
raises instead of falling back."""
import pathlib
import threading

import numpy as np
import pytest

from asr_finetune_tpu.data.collator import Collator as JCollator
from asr_finetune_tpu.data.collator import CollatorConfig as JCollatorConfig
from asr_finetune_tpu.evaluation import wer as jwer
from asr_finetune_tpu.models.tokenizer import ByteFallbackTokenizer as JTok
from asr_finetune_tpu.utils import native_ext as jnative
from asr_finetune_tpu_torch.data.collator import Collator, CollatorConfig
from asr_finetune_tpu_torch.evaluation import wer as twer
from asr_finetune_tpu_torch.models.tokenizer import ByteFallbackTokenizer
from asr_finetune_tpu_torch.ops import logmel
from asr_finetune_tpu_torch.utils import native_ext

REPO = pathlib.Path(__file__).resolve().parent.parent


def _random_pairs(seed, vocab, n, max_len):
    rng = np.random.default_rng(seed)
    return [(list(rng.choice(vocab, rng.integers(0, max_len))),
             list(rng.choice(vocab, rng.integers(0, max_len)))) for _ in range(n)]


def test_edit_distance_equals_jax_and_python():
    """tests/test_native.py's seeded pairs (seed 0, 20 words, up to 14 long)."""
    pairs = _random_pairs(0, [f"w{i}" for i in range(20)], 50, 15)
    assert jnative.available()
    for a, b in pairs:
        want = twer._edit_distance(a, b)
        assert want == jwer._edit_distance(a, b)
        assert native_ext.edit_distance_words(a, b) == want
        assert jnative.edit_distance_words(a, b) == want


@pytest.mark.parametrize("n_pairs", [30, 800])
@pytest.mark.parametrize("n_threads", [0, 1, 3])
def test_corpus_wer_equals_jax_and_python(n_threads, n_pairs):
    """30 pairs run inline whatever n_threads asks; 800 fan out over up to
    three threads (one per PAIRS_PER_THREAD pairs)."""
    rng = np.random.default_rng(1)
    vocab = ["der", "die", "das", "hund", "läuft", "heute"]
    refs = [" ".join(rng.choice(vocab, rng.integers(1, 9))) for _ in range(n_pairs)]
    hyps = [" ".join(rng.choice(vocab, rng.integers(1, 9))) for _ in range(n_pairs)]
    e, w = native_ext.corpus_wer(refs, hyps, n_threads)
    assert (e, w) == jnative.corpus_wer(refs, hyps, n_threads)
    assert e == sum(twer._edit_distance(r.split(), h.split()) for r, h in zip(refs, hyps))
    assert w == sum(len(r.split()) for r in refs)
    assert native_ext.corpus_wer([], []) == (0, 0)


@pytest.mark.parametrize("n_threads, n_pairs, cpus, want", [
    (0, 1, 64, 1),          # one utterance: inline
    (0, 255, 64, 1),        # under PAIRS_PER_THREAD pairs: inline
    (0, 512, 64, 2),        # a thread per 256 pairs
    (0, 100_000, 64, 8),    # at most min(cpu_count, 8)
    (0, 100_000, 2, 2),
    (3, 100_000, 64, 3),    # n_threads > 0 is the most it may start
    (16, 1024, 64, 4),
])
def test_corpus_wer_threads_follow_the_work(monkeypatch, n_threads, n_pairs, cpus, want):
    monkeypatch.setattr(native_ext.os, "cpu_count", lambda: cpus)
    assert native_ext._wer_threads(n_threads, n_pairs) == want


def test_pair_counts_and_wer_equal_jax():
    """The port's WER (through the C++ library) equals JAX's on 30 seeded
    pairs, bit for bit, and each pair's counts too."""
    rng = np.random.default_rng(5)
    vocab = ["und", "der", "Krieg", "über", "Straße", "1944", "weiß", "nicht"]
    refs = [" ".join(rng.choice(vocab, rng.integers(1, 12))) for _ in range(30)]
    hyps = [" ".join(rng.choice(vocab, rng.integers(0, 12))) for _ in range(30)]
    for r, h in zip(refs, hyps):
        assert twer._pair_counts(r, h) == jwer._pair_counts(r, h)
    assert twer.wer(refs, hyps) == jwer.wer(refs, hyps)
    assert twer.wer_percent(refs, hyps) == jwer.wer_percent(refs, hyps)
    with pytest.raises(ValueError, match="length mismatch"):
        twer.wer(refs, hyps[:-1])
    with pytest.raises(ValueError, match="no reference words"):
        twer.wer([""], ["a"])


@pytest.mark.parametrize("n_threads", [1, 0, 3])
def test_assemble_batch_equals_jax_and_numpy(n_threads):
    """Inline by default (n_threads 1), or over a pool when asked."""
    rng = np.random.default_rng(2)
    audios = [rng.standard_normal(n).astype(np.float32) for n in (100, 5000, 12000)]
    audios.append(rng.standard_normal(7000))          # float64: converted
    out = native_ext.assemble_batch(audios, 8000, n_threads)
    assert out.dtype == np.float32 and out.shape == (4, 8000)
    np.testing.assert_array_equal(out, jnative.assemble_batch(audios, 8000))
    np.testing.assert_array_equal(
        out, np.stack([logmel.pad_or_trim(np.asarray(a, np.float32), 8000) for a in audios]))
    assert native_ext.assemble_batch([], 16).shape == (0, 16)


def test_collator_audio_equals_jax():
    """The port's collator pads and trims through assemble_batch: its audio
    is bit-equal to JAX's collator's, below, at and above the 30 s window."""
    rng = np.random.default_rng(3)
    lens = (1, 16_000, logmel.CHUNK_SAMPLES, logmel.CHUNK_SAMPLES + 7, 500_000)
    rows = [(i, rng.standard_normal(n).astype(np.float32), f"wort {i}")
            for i, n in enumerate(lens)]
    ours = Collator(ByteFallbackTokenizer(), CollatorConfig())(rows)
    ref = JCollator(JTok(), JCollatorConfig())(rows)
    assert ours["audio"].dtype == np.float32
    np.testing.assert_array_equal(ours["audio"].view(np.uint32), ref["audio"].view(np.uint32))
    for k in ("decoder_input_ids", "labels", "idx"):
        np.testing.assert_array_equal(ours[k], ref[k])


def test_build_target():
    """Built into the git-ignored build/torch_native/, keyed by a hash of the
    source, the compiler and the flags; never into native/."""
    t = native_ext._target()
    assert native_ext.BUILD_DIR == REPO / "build" / "torch_native"
    assert t.parent == native_ext.BUILD_DIR and t.name.startswith("asr_native-")
    assert native_ext.SOURCE == REPO / "asr_finetune_tpu_torch" / "csrc" / "asr_native.cpp"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    native_ext.load()
    assert t.exists()


def test_build_key_follows_the_compiler(monkeypatch):
    base = native_ext._target()
    monkeypatch.setenv("CXX", "clang++")
    assert native_ext._target() != base


@pytest.mark.parametrize("how", ["CXX=/bin/false", "PATH without g++"])
def test_failed_build_raises(tmp_path, monkeypatch, how):
    """No fallback: a build that fails (the compiler exits non-zero, or is
    not found) raises RuntimeError, and the WER and the collator with it."""
    monkeypatch.setattr(native_ext, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native_ext, "_lib", None)
    if how == "CXX=/bin/false":
        monkeypatch.setenv("CXX", "/bin/false")
    else:
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="asr_native.cpp"):
        native_ext.load()
    with pytest.raises(RuntimeError):
        twer.wer(["a b"], ["a c"])
    with pytest.raises(RuntimeError):
        Collator(ByteFallbackTokenizer(), CollatorConfig())(
            [(0, np.zeros(10, np.float32), "a")])
    assert not list((tmp_path / "torch_native").glob("*.so"))


def test_first_load_from_many_threads(tmp_path, monkeypatch):
    """The first call may come from the prefetch thread while another runs:
    32 threads loading a library not yet built all get the one library, built
    once."""
    monkeypatch.setattr(native_ext, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native_ext, "_lib", None)
    builds = []
    real_build = native_ext._build
    monkeypatch.setattr(native_ext, "_build", lambda out: (builds.append(out), real_build(out)))
    got = []
    threads = [threading.Thread(target=lambda: got.append(native_ext.load())) for _ in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 32 and len({id(x) for x in got}) == 1
    assert len(builds) == 1
    assert native_ext.edit_distance_words(["a", "b"], ["a"]) == 1

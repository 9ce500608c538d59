"""The port honours the JAX package's data-staging flag and its two routing
switches, on the CPU:

- `--copy_to_local`: the HDF5 reader stages the file into the temp dir as
  the JAX reader's `_copy_to_local` does, reads the staged copy, and does
  not copy again while a copy of the same size is there;
- ASR_TPU_FUSED_DECODE (asr_finetune_tpu/evaluation/decode.py
  `_fused_default`): the same spellings route the decode as JAX does on the
  same config, an invalid value raises, an explicit `fused` wins, and the
  switch is read at every call; =1 over heads other than 64-dim raises in
  the port, where JAX warns and takes its plain path;
- ASR_TPU_ATTN_IMPL=xla (asr_finetune_tpu/ops/attention.py
  `_flash_available`): attention and the fused-qkv gate's auto mode take
  the route the JAX dispatch takes, read at every call.
"""
import shutil
import tempfile
import warnings

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.data import hdf5 as JH
from asr_finetune_tpu.evaluation import decode as JD
from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import WhisperConfig as JConfig
from asr_finetune_tpu.ops import attention as JA
from asr_finetune_tpu.ops import encoder_attention as JEA
from asr_finetune_tpu_torch.data import hdf5 as TH
from asr_finetune_tpu_torch.evaluation import decode as TD
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig
from asr_finetune_tpu_torch.ops import attention as TA

# 64-dim heads (the fused decode's and the fused-qkv kernels' requirement)
TINY = dict(vocab_size=613, num_mel_bins=16, d_model=256, encoder_layers=2,
            encoder_heads=4, decoder_layers=2, decoder_heads=4, d_ff=1024,
            max_source_positions=48, max_target_positions=64, eos_token_id=590,
            sot_token_id=591, translate_token_id=592, transcribe_token_id=593,
            no_timestamps_token_id=600, timestamp_begin_id=601, pad_token_id=590,
            first_language_token_id=592)
WIDE_HEADS = {**TINY, "decoder_heads": 2}        # 128-dim decoder heads
FORCED = [591, 592, 593]


# ---------------------------------------------------------------------------
# --copy_to_local
# ---------------------------------------------------------------------------

def test_copy_to_local_reads_the_staged_copy(tmp_path, monkeypatch):
    """A small HDF5 under a source dir is staged into the temp dir and read
    from there, row for row what the JAX reader reads from the source; a
    second open finds the copy of the same size and does not copy again."""
    src = tmp_path / "remote" / "data.h5"
    src.parent.mkdir()
    JH.make_synthetic_dataset(str(src), n=4, min_sec=0.2, max_sec=0.5)
    local = tmp_path / "local_tmp"
    local.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(local))
    copies = []
    real_copy = shutil.copyfile
    monkeypatch.setattr(shutil, "copyfile",
                        lambda a, b: copies.append((a, b)) or real_copy(a, b))

    reader = TH.Hdf5AudioReader(str(src), copy_to_local=True)
    assert reader.path == str(local / "data.h5") and len(copies) == 1
    assert (local / "data.h5").read_bytes() == src.read_bytes()
    rows = reader.read([0, 1, 2, 3])
    assert reader.file.filename == str(local / "data.h5")
    ref = JH.Hdf5AudioReader(str(src)).read([0, 1, 2, 3])
    assert [i for i, _, _ in rows] == [i for i, _, _ in ref]
    for (_, a, t), (_, ra, rt) in zip(rows, ref):
        np.testing.assert_array_equal(a, ra)
        assert t == rt

    again = TH.Hdf5AudioReader(str(src), copy_to_local=True)
    assert again.path == reader.path and len(copies) == 1
    assert len(again) == 4
    # without the flag the source is read in place
    assert TH.Hdf5AudioReader(str(src)).path == str(src)


def test_copy_to_local_restages_a_changed_file(tmp_path, monkeypatch):
    """A staged copy whose size differs from the source (the source was
    rewritten) is replaced, as in the JAX reader."""
    src = tmp_path / "data.h5"
    JH.make_synthetic_dataset(str(src), n=2, min_sec=0.2, max_sec=0.3)
    local = tmp_path / "tmp"
    local.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(local))
    (local / "data.h5").write_bytes(b"stale")
    reader = TH.Hdf5AudioReader(str(src), copy_to_local=True)
    assert (local / "data.h5").read_bytes() == src.read_bytes()
    with h5py.File(reader.path, "r") as f:
        assert len(f["audio"]) == 2


# ---------------------------------------------------------------------------
# ASR_TPU_FUSED_DECODE
# ---------------------------------------------------------------------------

def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("env", ["0", "1", "true", "OFF", "on", "yes", "no", ""])
def test_fused_decode_switch_matches_jax(monkeypatch, env):
    """Every JAX spelling routes the port's decode as the JAX decode on the
    same config, on the CPU and on a card alike; an explicit fused wins."""
    _set(monkeypatch, "ASR_TPU_FUSED_DECODE", env)
    want = JD._fused_default(JConfig(**TINY))
    cfg = TConfig(**TINY)
    for dev in ("cpu", "cuda"):
        assert TD._resolve_fused(None, cfg, torch.device(dev)) == want
    assert TD._resolve_fused(False, cfg, torch.device("cuda")) is False
    assert TD._resolve_fused(True, cfg, torch.device("cpu")) is True


def test_fused_decode_switch_unset_keeps_the_device_rule(monkeypatch):
    """Unset: JAX on its CPU backend decodes plain, as the port does on the
    CPU; the port's card default stays fused."""
    monkeypatch.delenv("ASR_TPU_FUSED_DECODE", raising=False)
    cfg = TConfig(**TINY)
    assert JD._fused_default(JConfig(**TINY)) is False
    assert TD._resolve_fused(None, cfg, torch.device("cpu")) is False
    assert TD._resolve_fused(None, cfg, torch.device("cuda")) is True


def test_fused_decode_switch_rejects_bad_values_and_wide_heads(monkeypatch):
    """An invalid value raises in both packages; =1 over 128-dim heads
    raises in the port (JAX warns and takes its plain path)."""
    monkeypatch.setenv("ASR_TPU_FUSED_DECODE", "maybe")
    with pytest.raises(ValueError, match="ASR_TPU_FUSED_DECODE"):
        JD._fused_default(JConfig(**TINY))
    with pytest.raises(ValueError, match="ASR_TPU_FUSED_DECODE"):
        TD._resolve_fused(None, TConfig(**TINY), torch.device("cuda"))
    monkeypatch.setenv("ASR_TPU_FUSED_DECODE", "1")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert JD._fused_default(JConfig(**WIDE_HEADS)) is False
    assert any("head_dim" in str(w.message) for w in caught)
    with pytest.raises(ValueError, match="64-dim heads"):
        TD._resolve_fused(None, TConfig(**WIDE_HEADS), torch.device("cpu"))


@pytest.fixture(scope="module")
def tiny_model():
    jparams = JW.init_params(jax.random.PRNGKey(0), JConfig(**TINY))
    tparams = TIO.params_from_numpy(JIO._flatten(jparams), "cpu")
    mel = np.random.default_rng(1).standard_normal(
        (2, 2 * TINY["max_source_positions"], TINY["num_mel_bins"])).astype(np.float32)
    return tparams, torch.from_numpy(mel)


def test_fused_decode_switch_is_read_at_every_call(tiny_model, monkeypatch):
    """A greedy decode on the CPU takes the fused step under =1 and the
    plain one under =0, switched between two calls in one process; the
    tokens are the same (fp32)."""
    tparams, mel = tiny_model
    calls = []
    real = TW.decode_step_fused
    monkeypatch.setattr(TW, "decode_step_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for env in ("1", "0"):
        monkeypatch.setenv("ASR_TPU_FUSED_DECODE", env)
        n0 = len(calls)
        out[env] = TD.greedy_decode(tparams, mel, TConfig(**TINY), FORCED, 8,
                                    compute_dtype=torch.float32)
        assert (len(calls) > n0) == (env == "1")
    for a, b in zip(out["1"], out["0"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ASR_TPU_ATTN_IMPL
# ---------------------------------------------------------------------------

def _routes(monkeypatch):
    """Record which path each package's attention dispatch takes: the
    encoder-attention kernel or plain softmax attention."""
    routes = []
    monkeypatch.setattr(JA, "_flash_import_ok", lambda: True)   # as on the JAX package's TPU
    monkeypatch.setattr(JEA, "encoder_attention",
                        lambda q, k, v, save_tag=None: routes.append("kernel") or q)
    monkeypatch.setattr(JA, "xla_attention",
                        lambda q, k, v, mask=None, causal=False: routes.append("xla") or q)
    monkeypatch.setattr(TA, "encoder_attention", lambda q, k, v: routes.append("kernel") or q)
    monkeypatch.setattr(TA, "xla_attention",
                        lambda q, k, v, mask=None, causal=False: routes.append("xla") or q)
    return routes


@pytest.mark.parametrize("env", [None, "xla", "XLA", "pallas"])
def test_attn_impl_switch_matches_jax(monkeypatch, env):
    """Non-causal unmasked attention (B 1, T 256, 4 heads of 64): the port
    routes as the JAX dispatch under the same ASR_TPU_ATTN_IMPL."""
    routes = _routes(monkeypatch)
    _set(monkeypatch, "ASR_TPU_ATTN_IMPL", env)
    x = np.zeros((1, 256, 4, 64), np.float32)
    JA.attention(*(jnp.asarray(x),) * 3)
    TA.attention(*(torch.from_numpy(x),) * 3)
    want = "xla" if env is not None and env.lower() == "xla" else "kernel"
    assert routes == [want, want]


def test_attn_impl_switch_is_read_at_every_call(monkeypatch):
    """Set, cleared, set again within one process: each call follows the
    environment as it is at that call, in both packages."""
    routes = _routes(monkeypatch)
    x = np.zeros((1, 128, 2, 64), np.float32)
    for env in ("xla", None, "xla"):
        _set(monkeypatch, "ASR_TPU_ATTN_IMPL", env)
        JA.attention(*(jnp.asarray(x),) * 3)
        TA.attention(*(torch.from_numpy(x),) * 3)
    assert routes == ["xla", "xla", "kernel", "kernel", "xla", "xla"]


@pytest.mark.parametrize("env", [None, "xla"])
def test_attn_impl_switch_gates_fused_qkv_auto_as_jax(monkeypatch, env):
    """ASR_TPU_FUSED_QKV=auto engages the fused-qkv path where the dispatch
    would run the kernel: not under ASR_TPU_ATTN_IMPL=xla, in either
    package (the port's auto needs a card besides)."""
    monkeypatch.setattr(JA, "_flash_import_ok", lambda: True)
    monkeypatch.setenv("ASR_TPU_FUSED_QKV", "auto")
    _set(monkeypatch, "ASR_TPU_ATTN_IMPL", env)
    want = env is None
    assert JW._fused_qkv_ok(JConfig(**TINY), 256, "auto") is want
    assert TW._fused_qkv_ok(TConfig(**TINY), 256, "auto", torch.device("cuda")) is want

"""Port parity for the fused log-mel frontend (ops/logmel_fused.py, the
counterpart of the Pallas `log_mel_pallas`): its plain version, the CPU path
of the CUDA kernel's wrapper, against the JAX Pallas kernel in interpret
mode, at tests/test_logmel_pallas.py's atol 1e-4."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.ops import logmel_pallas as JLP
from asr_finetune_tpu_torch.ops import logmel as TLM
from asr_finetune_tpu_torch.ops import logmel_fused as TLF


def _audio(seed, B=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, TLM.CHUNK_SAMPLES)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_fused_plain_matches_jax_pallas(n_mels):
    """B 1 at the released models' 80 and 128 mel bins."""
    audio = _audio(n_mels)
    ref = np.asarray(JLP.log_mel_pallas(jnp.asarray(audio), n_mels, interpret=True))
    out = TLF.log_mel_fused_plain(torch.from_numpy(audio), n_mels)
    assert out.shape == ref.shape == (1, 3000, n_mels) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version_and_the_production_form():
    """On a CPU tensor the wrapper runs the plain version; the function is
    the production conv form's (ops/logmel.log_mel_spectrogram), within the
    sum-order differences of fp32; silence floors at the global max − 8."""
    audio = torch.from_numpy(_audio(3, B=2))
    audio[1, :200_000] = 0.0
    out = TLF.log_mel_fused(audio, 80)
    torch.testing.assert_close(out, TLF.log_mel_fused_plain(audio, 80), rtol=0, atol=0)
    torch.testing.assert_close(out, TLM.log_mel_spectrogram(audio, 80), rtol=0, atol=1e-5)
    raw = TLF.log10_mel_plain(audio, 80)
    assert float(out[1, :1000].min()) == pytest.approx(
        (float(raw[1].max()) - 8.0 + 4.0) / 4.0)


def test_no_entry_point_calls_it():
    """Like log_mel_pallas in the JAX package, the fused frontend is a public
    function on no path: no other module of the port imports it."""
    pkg = pathlib.Path(TLF.__file__).resolve().parents[1]
    users = [p for p in pkg.rglob("*.py")
             if "logmel_fused" in p.read_text() and p.name != "logmel_fused.py"]
    assert users == []

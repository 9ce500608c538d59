"""The port stands alone: asr_finetune_tpu_torch imports neither JAX nor the
JAX package, builds nothing when imported, and its entry points refuse to
carry on on the CPU unless asked to."""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_imports_without_jax_or_the_jax_package():
    """Every port module imports with `jax` made unimportable, and no
    asr_finetune_tpu module is loaded along the way."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
            del sys.modules[name]
        sys.modules["jax"] = None          # any `import jax` now raises
        import asr_finetune_tpu_torch as pkg
        names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m == "asr_finetune_tpu" or m.startswith("asr_finetune_tpu."))
        assert not leaked, leaked
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 20


def test_chip_smoke_imports_nothing_of_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "asr_finetune_tpu." not in src.replace(
        "asr_finetune_tpu_torch", "")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from asr_finetune_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_transcribe_cli_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from asr_finetune_tpu_torch.cli import transcribe
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transcribe.main(["--inputs", str(tmp_path / "none.wav"),
                         "--model_type", "test-nano"])


def test_build_plan():
    """Kernels build from csrc/ into the git-ignored build/torch_kernels/,
    keyed by a hash of the sources; nothing is compiled on import."""
    from asr_finetune_tpu_torch.ops import _build
    assert _build.sources() == ["decoder_fused", "encoder_attention", "logmel", "w8a8"]
    assert _build.BUILD_DIR == REPO / "build" / "torch_kernels"
    t = _build._target("decoder_fused")
    assert t.parent == _build.BUILD_DIR and t.name.startswith("decoder_fused-")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "build/" in (REPO / ".gitignore").read_text().split()
    with pytest.raises(TypeError):
        _build.dtype_code(torch.zeros(1, dtype=torch.float16))


def test_pending_model_options_raise():
    """The options of paths not ported yet raise before a run starts
    (--peft and --load_in_8bit are ported and build: tests/test_torch_peft.py;
    beams and --decode_kv_int8 are served: tests/test_torch_evaluate.py)."""
    from asr_finetune_tpu_torch import config, run
    for flag in ("--offload_param", "--spec_augment", "--host_logmel"):
        args = config.parse_args(["--model_type", "test-nano", "--device", "cpu",
                                  "--peft", "--load_in_8bit", flag])
        with pytest.raises(NotImplementedError, match=flag):
            run._check_pending_training(args)

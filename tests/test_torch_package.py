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


def test_imports_without_the_optional_packages():
    """transformers (cli.verify_parity, the classify judge), matplotlib
    (classify.plots) and h5py (data.hdf5) are imported only in the calls
    that need them: every port module imports with all three unimportable."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("transformers", "matplotlib", "h5py"):
            sys.modules[name] = None
        import asr_finetune_tpu_torch as pkg
        names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 30


def test_every_jax_module_has_a_port_counterpart():
    """Every module of asr_finetune_tpu has one of the same name in the
    port (the two imports tests above then load each), but the Pallas
    log-mel kernel's module, whose counterpart is ops/logmel_fused.py."""
    def modules(pkg):
        return {p.relative_to(REPO / pkg).as_posix() for p in (REPO / pkg).rglob("*.py")}
    port = modules("asr_finetune_tpu_torch")
    assert modules("asr_finetune_tpu") - port == {"ops/logmel_pallas.py"}
    assert {"ops/logmel_fused.py", "paths.py", "utils/misc.py", "utils/profiling.py"} <= port


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
    """--tp > 1 in one process raises before a run starts (the world does
    not divide into tensor-parallel groups, as JAX's create_mesh raises;
    two ranks train: tests/test_torch_tp.py); --spec_augment and
    --host_logmel pass the check and train
    (tests/test_torch_train_cli.py::test_options_not_ported_raise), as do
    --peft and --load_in_8bit (tests/test_torch_peft.py), --offload_param
    and --offload_optimizer (tests/test_torch_parallel.py)."""
    from asr_finetune_tpu_torch import config, run
    base = ["--model_type", "test-nano", "--device", "cpu", "--peft", "--load_in_8bit"]
    with pytest.raises(ValueError, match="tensor-parallel groups of 2"):
        run.check_parallel_layout(config.parse_args(base + ["--tp=2"]))
    for flags in (["--spec_augment"], ["--host_logmel"],
                  ["--offload_param", "--offload_optimizer"]):
        run.check_parallel_layout(config.parse_args(base + flags))

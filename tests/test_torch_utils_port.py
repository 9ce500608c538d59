"""The port's copies of the JAX package's last three modules against their
originals: paths (the ASR_TPU_* environment), utils/misc (step-count
bookkeeping) and utils/profiling (a trace written on the CPU; its spans
and counters are tests/test_torch_tracing.py's)."""
import importlib
import json

import pytest
import torch

import asr_finetune_tpu.paths as jpaths
import asr_finetune_tpu_torch.paths as tpaths
from asr_finetune_tpu.utils import misc as jmisc
from asr_finetune_tpu_torch.utils import misc as tmisc
from asr_finetune_tpu_torch.utils import profiling as tprof

PATH_ENV = ("ASR_TPU_PROJECT_ROOT", "ASR_TPU_MODEL_PATH", "ASR_TPU_DATA_PATH",
            "ASR_TPU_RESULTS_PATH")
PATH_NAMES = ("PROJECT_ROOT", "MODEL_PATH", "DATA_PATH", "RESULTS_PATH")


@pytest.mark.parametrize("n", [0, 1, 7, 16, 1001])
@pytest.mark.parametrize("batch", [0, 1, 3, 16])
@pytest.mark.parametrize("k", [0, 1, 5])
def test_misc_equals_jax(n, batch, k):
    assert tmisc.steps_per_epoch(n, batch) == jmisc.steps_per_epoch(n, batch)
    assert tmisc.total_steps(n, batch, k) == jmisc.total_steps(n, batch, k)
    assert tmisc.num_checkpoint_iterations(n, k) == jmisc.num_checkpoint_iterations(n, k)


@pytest.mark.parametrize("env", [
    {}, {"ASR_TPU_PROJECT_ROOT": "/srv/asr"},
    {"ASR_TPU_PROJECT_ROOT": "/srv/asr", "ASR_TPU_DATA_PATH": "/data/de"},
    dict(zip(PATH_ENV, ("/p", "/m", "/d", "/r")))])
def test_paths_equal_jax(monkeypatch, tmp_path, env):
    """Both modules read at import: reloaded under the same environment and
    working directory, they name the same paths."""
    monkeypatch.chdir(tmp_path)
    for name in PATH_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    try:
        ours, ref = importlib.reload(tpaths), importlib.reload(jpaths)
        assert {k: getattr(ours, k) for k in PATH_NAMES} == \
            {k: getattr(ref, k) for k in PATH_NAMES}
        if "ASR_TPU_PROJECT_ROOT" not in env:
            assert ours.PROJECT_ROOT == str(tmp_path)
    finally:
        monkeypatch.undo()
        importlib.reload(tpaths)
        importlib.reload(jpaths)


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    """A profiled block leaves one Chrome-trace JSON holding its ops."""
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "prof"), create_perfetto_link=True):
        (x @ x).relu_()
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)

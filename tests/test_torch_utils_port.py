"""The port's copies of the JAX package's last three modules against their
originals: paths (the ASR_TPU_* environment), utils/misc (step-count
bookkeeping) and utils/profiling (host and device memory under the JAX
keys, the throughput window, a trace written on the CPU)."""
import importlib
import json
import types

import jax
import pytest
import torch

import asr_finetune_tpu.paths as jpaths
import asr_finetune_tpu_torch.paths as tpaths
from asr_finetune_tpu.utils import misc as jmisc
from asr_finetune_tpu.utils import profiling as jprof
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


def test_log_memory_usage_keys(monkeypatch):
    """On the CPU: host RSS only (no card in use). With two cards in use,
    the keys are JAX's for two devices, the values the allocator's bytes
    now and at its peak, in GB."""
    host = tprof.log_memory_usage("cpu", quiet=True)
    assert set(host) == {"host_rss_gb"} and host["host_rss_gb"] > 0
    stats = {0: (3e9, 5e9), 1: (1e9, 2e9)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: {
        "allocated_bytes.all.current": stats[d][0], "allocated_bytes.all.peak": stats[d][1]})
    ours = tprof.log_memory_usage("two cards")
    devices = [types.SimpleNamespace(id=d, memory_stats=lambda d=d: {
        "bytes_in_use": stats[d][0], "peak_bytes_in_use": stats[d][1]}) for d in stats]
    monkeypatch.setattr(jax, "local_devices", lambda: devices)
    ref = jprof.log_memory_usage("two cards")
    assert set(ours) == set(ref)
    assert {k: v for k, v in ours.items() if k != "host_rss_gb"} == \
        {k: v for k, v in ref.items() if k != "host_rss_gb"} == {
            "0_bytes_in_use_gb": 3.0, "0_peak_gb": 5.0, "1_bytes_in_use_gb": 1.0,
            "1_peak_gb": 2.0}


def test_step_timer_rates(monkeypatch):
    """The same window as JAX's StepTimer on the same clock."""
    clock = iter([100.0, 100.0, 104.0, 104.0, 104.0, 106.0, 106.0])
    monkeypatch.setattr("time.time", lambda: next(clock))
    ours, ref = tprof.StepTimer(), jprof.StepTimer()
    for t in (ours, ref):
        t.update(8, 200)
        t.update(4, 100)
    assert ours.rates() == ref.rates() == {"utt_per_sec": 3.0, "tokens_per_sec": 75.0}
    ours.reset()
    ours.update(2, 10)
    assert ours.rates() == {"utt_per_sec": 1.0, "tokens_per_sec": 5.0}


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    """A profiled block leaves one Chrome-trace JSON holding its ops."""
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "prof"), create_perfetto_link=True):
        (x @ x).relu_()
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)

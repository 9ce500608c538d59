"""Profiling and telemetry (counterpart of asr_finetune_tpu/utils/profiling.py).

- `trace(logdir)`: a torch.profiler context over the host and, where a
  card is in use, its CUDA kernels; writes a Chrome-trace JSON
  (`<host>_<pid>.<time>.pt.trace.json`) under logdir, which TensorBoard's
  PyTorch profiler view and Perfetto (ui.perfetto.dev) open. It takes the
  place of JAX's XLA profile of jax.profiler.start_trace.
- `log_memory_usage`: psutil RSS (reference evaluation/utils.py:45-48)
  plus the caching allocator's device memory per visible card, under the
  JAX keys "{id}_bytes_in_use_gb" and "{id}_peak_gb" (bytes allocated now
  and at most since the last reset of the peak; GB of 1e9 bytes).
- `StepTimer`: rolling utt/s / tokens/s window, the structured version of
  the collator's samples/sec prints (datasets_and_collators.py:197-204).
"""
from __future__ import annotations

import contextlib
import glob
import logging
import os
import time
from typing import Dict, Iterator

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Profile the block into logdir. create_perfetto_link: also log the
    trace file to load into ui.perfetto.dev (nothing is uploaded)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
    logger.info("profile trace written to %s (view: tensorboard --logdir %s, PyTorch "
                "Profiler tab)", logdir, logdir)
    if create_perfetto_link:
        newest = max(glob.glob(os.path.join(logdir, "*.pt.trace.json")), key=os.path.getmtime)
        logger.info("open %s in https://ui.perfetto.dev", newest)


def log_memory_usage(tag: str = "", quiet: bool = False) -> Dict[str, float]:
    stats: Dict[str, float] = {}
    try:
        import psutil
        stats["host_rss_gb"] = psutil.Process().memory_info().rss / 1e9
    except ImportError:
        pass
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for d in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(d)
            if ms:
                stats[f"{d}_bytes_in_use_gb"] = ms.get("allocated_bytes.all.current", 0) / 1e9
                stats[f"{d}_peak_gb"] = ms.get("allocated_bytes.all.peak", 0) / 1e9
    if stats and not quiet:
        logger.info("memory%s: %s", f" [{tag}]" if tag else "",
                    {k: round(v, 3) for k, v in stats.items()})
    return stats


class StepTimer:
    """Rolling throughput window."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.time()
        self.utterances = 0
        self.tokens = 0

    def update(self, utterances: int, tokens: int):
        self.utterances += utterances
        self.tokens += tokens

    def rates(self) -> Dict[str, float]:
        dt = max(time.time() - self.t0, 1e-9)
        return {"utt_per_sec": self.utterances / dt,
                "tokens_per_sec": self.tokens / dt}

"""Metrics logging for the port: JSONL history, TensorBoard scalars when
available, config dumps, memory readings.

Counterpart of asr_finetune_tpu/utils/logging_utils.py, single process:
`MetricsLogger` appends every record to `metrics.jsonl` and mirrors the
float fields to TensorBoard when `torch.utils.tensorboard` imports (as the
JAX module, :60-68). The JAX module's per-host files (metrics_host<i>.jsonl)
are not ported: the port trains on one card. `memory_stats` is the memory
line of a logging record: host RSS and, on a card, the device memory in
use and its peak (`torch.cuda.max_memory_allocated`).
"""
from __future__ import annotations

import json
import logging
import os
import resource
import time
from typing import Any, Dict

import torch

logger = logging.getLogger(__name__)


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def memory_stats(device: torch.device) -> Dict[str, float]:
    """{"host_rss_gb"[, "cuda_mem_in_use_gb", "cuda_peak_gb"]} (GiB)."""
    out = {"host_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
           / 2 ** 20}
    if device.type == "cuda":
        out["cuda_mem_in_use_gb"] = torch.cuda.memory_allocated(device) / 2 ** 30
        out["cuda_peak_gb"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    return out


class MetricsLogger:
    """Appends metric dicts to metrics.jsonl and mirrors them to TB."""

    def __init__(self, directory: str, use_tensorboard: bool = True):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._jsonl = open(os.path.join(directory, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=directory)
            except Exception as e:  # noqa: BLE001
                logger.warning("tensorboard writer unavailable: %s", e)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def dump_config(directory: str, config: Dict[str, Any],
                filename: str = "config.txt") -> None:
    """Append the parsed config, one flag per line."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, filename), "a") as f:
        f.write(f"# {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
        for k in sorted(config):
            f.write(f"{k} = {config[k]!r}\n")
        f.write("\n")


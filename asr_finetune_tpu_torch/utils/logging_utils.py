"""Metrics logging for the port: JSONL history, TensorBoard scalars when
available, config dumps, memory readings.

Counterpart of asr_finetune_tpu/utils/logging_utils.py (:34-112):
`MetricsLogger` has two channels. The global records (`log`) go to
`metrics.jsonl` and, when `torch.utils.tensorboard` imports, to
TensorBoard, from rank 0 only (every rank computes the same values). The
per-process telemetry (`log_host`) goes to `metrics_host<r>.jsonl`, its
records carrying `process_index`, and a `host<r>/` TensorBoard run, from
every rank. `memory_stats` is the memory line of a logging record: host
RSS and, on a card, the device memory in use and its peak
(`torch.cuda.max_memory_allocated`).
"""
from __future__ import annotations

import json
import logging
import os
import resource
import time
from typing import Any, Dict

import torch

from ..parallel import mesh

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
    """Appends global metric dicts to metrics.jsonl and mirrors them to TB
    (rank 0), and this process's telemetry to metrics_host<r>.jsonl."""

    def __init__(self, directory: str, use_tensorboard: bool = True):
        self.directory = directory
        self._pi = mesh.rank()
        self._active = self._pi == 0
        os.makedirs(directory, exist_ok=True)
        self._jsonl = (open(os.path.join(directory, "metrics.jsonl"), "a")
                       if self._active else None)
        self._host_jsonl = open(
            os.path.join(directory, f"metrics_host{self._pi}.jsonl"), "a")
        self._tb = self._host_tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                if self._active:
                    self._tb = SummaryWriter(log_dir=directory)
                self._host_tb = SummaryWriter(
                    log_dir=os.path.join(directory, f"host{self._pi}"))
            except Exception as e:  # noqa: BLE001
                logger.warning("tensorboard writer unavailable: %s", e)

    @staticmethod
    def _write(jsonl, tb, rec: Dict[str, Any], step: int, skip=("step", "time")) -> None:
        jsonl.write(json.dumps(rec) + "\n")
        jsonl.flush()
        if tb is not None:
            for k, v in rec.items():
                if k not in skip and isinstance(v, float):
                    tb.add_scalar(k, v, step)

    @staticmethod
    def _record(step: int, metrics: Dict[str, Any], **extra) -> Dict[str, Any]:
        rec = {"step": int(step), "time": time.time(), **extra}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        return rec

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        """A global record (rank 0 writes it; the others drop it)."""
        if self._active:
            self._write(self._jsonl, self._tb, self._record(step, metrics), step)

    def log_host(self, step: int, metrics: Dict[str, Any]) -> None:
        """This process's telemetry, called on every rank."""
        rec = self._record(step, metrics, process_index=self._pi)
        self._write(self._host_jsonl, self._host_tb, rec, step,
                    skip=("step", "time", "process_index"))

    def close(self) -> None:
        for f in (self._jsonl, self._host_jsonl, self._tb, self._host_tb):
            if f is not None:
                f.close()


def dump_config(directory: str, config: Dict[str, Any],
                filename: str = "config.txt") -> None:
    """Append the parsed config, one flag per line."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, filename), "a") as f:
        f.write(f"# {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
        for k in sorted(config):
            f.write(f"{k} = {config[k]!r}\n")
        f.write("\n")


"""Deterministic host input pipeline: shuffle, batch, prefetch (PyTorch port).

Counterpart of asr_finetune_tpu/data/pipeline.py, single process:

- `IndexSampler`: seeded per-epoch shuffling, optional length grouping
  (sort within windows of batch × 16 by transcript length, HF
  LengthGroupedSampler's role) and `batches_from_step`, the infinite stream
  resumable at a global step, so a resumed run sees exactly the batches an
  uninterrupted one would;
- `DataPipeline`: reader + collator + sampler → numpy batches, bad rows
  replaced by repeats of good ones so every batch has its configured size;
- `device_prefetch`: a background thread turns batches into pinned host
  tensors and the consumer copies them to the device with
  non_blocking=True; a producer exception is re-raised on the consumer
  side instead of ending the stream silently.

The JAX package's multi-process sharding (process_index / process_count,
make_global_batch) is not ported: the port trains on one card.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

NON_DEVICE_KEYS = ("text", "idx")  # host-only fields, never copied to the device


LENGTH_GROUP_FACTOR = 16   # length grouping sorts windows of batch x this
TELEMETRY_EVERY = 5        # batches between samples/sec log lines


class IndexSampler:
    """Seeded, epoch-aware index stream (shuffled, the ragged tail of an
    epoch dropped); with `lengths`, length-grouped."""

    def __init__(self, n: int, batch_size: int, seed: int = 0,
                 lengths: Optional[np.ndarray] = None):
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self.lengths = None if lengths is None else np.asarray(lengths)

    def epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        np.random.default_rng(self.seed + epoch).shuffle(idx)
        if self.lengths is not None:
            w = self.batch_size * LENGTH_GROUP_FACTOR
            for i in range(0, len(idx), w):
                win = idx[i : i + w]
                idx[i : i + len(win)] = win[np.argsort(self.lengths[win],
                                                       kind="stable")]
        return idx[: (len(idx) // self.batch_size) * self.batch_size]

    def batches(self, epoch: int) -> Iterator[np.ndarray]:
        idx = self.epoch_indices(epoch)
        for i in range(0, len(idx) - self.batch_size + 1, self.batch_size):
            yield idx[i : i + self.batch_size]

    def batches_from_step(self, start_step: int) -> Iterator[np.ndarray]:
        """Infinite stream resumable at a global step (the epoch follows
        from the step count)."""
        per_epoch = len(self.epoch_indices(0)) // self.batch_size
        if per_epoch == 0:
            raise ValueError(
                f"train split ({len(self.epoch_indices(0))} rows) is smaller "
                f"than the batch ({self.batch_size}); reduce "
                "per_device_train_batch_size or provide more data")
        step = start_step
        while True:
            epoch, offset = divmod(step, per_epoch)
            for j, b in enumerate(self.batches(epoch)):
                if j < offset:
                    continue
                yield b
                step += 1


class DataPipeline:
    """reader + collator + sampler → batches of numpy arrays."""

    def __init__(self, reader, collator: Callable, sampler: IndexSampler):
        self.reader = reader
        self.collator = collator
        self.sampler = sampler

    def iter_from_step(self, start_step: int) -> Iterator[Dict[str, np.ndarray]]:
        t0 = time.time()
        seen = 0
        for i, idx_batch in enumerate(self.sampler.batches_from_step(start_step)):
            rows = self.reader.read(idx_batch)
            if len(rows) == 0:
                continue
            want = len(idx_batch)
            if len(rows) < want:
                # readers drop bad rows; repeat good rows so every train
                # batch has the configured size
                rows = [rows[j % len(rows)] for j in range(want)]
            batch = self.collator(rows)
            seen += len(rows)
            if (i + 1) % TELEMETRY_EVERY == 0:
                logger.info("data: %.1f samples/sec", seen / max(time.time() - t0, 1e-9))
            yield batch


def to_device(batch: Dict[str, Any], device: torch.device,
              accum_steps: int = 1) -> Dict[str, Any]:
    """numpy (or pinned host) batch → device tensors; host-only fields pass
    through. With accum_steps > 1 every device leaf becomes
    (accum, micro, ...)."""
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if k in NON_DEVICE_KEYS:
            out[k] = v
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        if accum_steps > 1:
            B = t.shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} not divisible by accum_steps {accum_steps}")
            t = t.reshape((accum_steps, B // accum_steps) + tuple(t.shape[1:]))
        out[k] = t.to(device, non_blocking=True)
    return out


def _pin(batch: Dict[str, Any], pin: bool) -> Dict[str, Any]:
    out = {}
    for k, v in batch.items():
        if k in NON_DEVICE_KEYS:
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory() if pin else t
    return out


def device_prefetch(it: Iterator[Dict[str, np.ndarray]], device: torch.device,
                    size: int = 2, accum_steps: int = 1
                    ) -> Iterator[Dict[str, Any]]:
    """A background thread stages host batches (pinned when the device is
    a card); the consumer copies them to `device` asynchronously.

    With accum_steps > 1, every device leaf is reshaped to (accum, micro,
    ...) for the train step's microbatch loop."""
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    _END = object()
    stop = threading.Event()
    pin = device.type == "cuda"
    # producer exception, re-raised on the consumer side: without this, a
    # pipeline error (e.g. a split smaller than one batch) dies in the
    # thread and the trainer only sees the stream end
    err: list = []

    def produce():
        # put() with a timeout + stop poll: an abandoned consumer must not
        # leave this thread parked forever in q.put
        try:
            for b in it:
                staged = _pin(b, pin)
                while not stop.is_set():
                    try:
                        q.put(staged, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — carried to the consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.2)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            b = q.get()
            if b is _END:
                if err:
                    raise err[0]
                return
            yield to_device(b, device, accum_steps)
    finally:
        # generator close (explicit, GC, or shutdown) releases the producer
        stop.set()
        t.join(timeout=5.0)

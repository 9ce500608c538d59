"""Shared helpers: step-count bookkeeping (a copy of
asr_finetune_tpu/utils/misc.py).

Capability parity with the reference's training/utils.py:100-116 and the
formulas its README documents (README.md:95-97):
  total_steps = ceil(len_train / batch_size) * epochs
  iterations  = ceil(total_steps / save_steps)
"""
from __future__ import annotations

import math


def steps_per_epoch(len_train_set: int, batch_size: int) -> int:
    return math.ceil(len_train_set / max(batch_size, 1))


def total_steps(len_train_set: int, batch_size: int, epochs: int) -> int:
    return steps_per_epoch(len_train_set, batch_size) * epochs


def num_checkpoint_iterations(total: int, save_steps: int) -> int:
    return math.ceil(total / max(save_steps, 1))

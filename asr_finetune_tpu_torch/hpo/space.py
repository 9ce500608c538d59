"""Hyperparameter search space.

A copy of asr_finetune_tpu/hpo/space.py, which imports no JAX: the port
imports nothing of the JAX package, so it keeps its own. Change the two
together (tests/test_torch_hpo.py holds them equal).

Capability parity with the reference's `get_whisper_hyperparameters`
(ray_searchers_and_schedulers.py:99-166): lr loguniform(5e-6, 1e-4), warmup
steps/ratio choices, per-device batch size choice([1,2,4,8]), weight decay
loguniform(1e-6, 1e-2), lr scheduler choice([linear, cosine]), and for PEFT
LoRA alpha randint(2, 6) and rank randint(1, 17) (:147-151). The
`--hyperparameters` flag selects which dimensions are active, as in the
reference (:123-164).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class Domain:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError


@dataclasses.dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(math.log(self.low), math.log(self.high))))


@dataclasses.dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


@dataclasses.dataclass
class Choice(Domain):
    values: Sequence[Any]

    def sample(self, rng):
        return self.values[int(rng.integers(len(self.values)))]


@dataclasses.dataclass
class RandInt(Domain):
    low: int
    high: int  # exclusive, numpy convention (reference uses tune.randint)

    def sample(self, rng):
        return int(rng.integers(self.low, self.high))


def get_whisper_hyperparameters(args) -> Dict[str, Domain]:
    """Active search dimensions from args.hyperparameters (flat list of
    names; None → the reference's default set)."""
    requested: Optional[List[str]] = None
    if getattr(args, "hyperparameters", None):
        requested = [h for group in args.hyperparameters for h in group]

    space: Dict[str, Domain] = {}

    def want(name):
        return requested is None or name in requested

    if want("learning_rate"):
        space["learning_rate"] = LogUniform(5e-6, 1e-4)
    if want("warmup_steps") and getattr(args, "warmup_steps", 0):
        # reference ray_searchers_and_schedulers.py:139-140
        space["warmup_steps"] = Choice([100, 500, 1000, 2000])
    elif want("warmup_ratio"):
        # reference ray_searchers_and_schedulers.py:141-142
        space["warmup_ratio"] = Choice([0.01, 0.03, 0.05, 0.1])
    if want("per_device_train_batch_size"):
        space["per_device_train_batch_size"] = Choice([1, 2, 4, 8])
    if want("weight_decay"):
        space["weight_decay"] = LogUniform(1e-6, 1e-2)
    if want("lr_scheduler_type"):
        space["lr_scheduler_type"] = Choice(["linear", "cosine"])
    if getattr(args, "peft", False):
        if want("alpha"):
            space["alpha"] = RandInt(2, 6)       # reference :147-148
        if want("rank"):
            space["rank"] = RandInt(1, 17)       # reference :149-151
    return space


def sample_config(space: Dict[str, Domain], rng: np.random.Generator
                  ) -> Dict[str, Any]:
    return {k: d.sample(rng) for k, d in space.items()}

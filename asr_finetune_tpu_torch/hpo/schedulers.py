"""Trial schedulers: ASHA early stopping and PBT perturbation policy.

A copy of asr_finetune_tpu/hpo/schedulers.py, which imports no JAX: the port
imports nothing of the JAX package, so it keeps its own. Change the two
together (tests/test_torch_hpo.py holds them equal).

Capability parity with the reference's scheduler factory
(ray_searchers_and_schedulers.py:12-96):
- `small_small` / `large_small_*`: ASHAScheduler(time_attr="step",
  reduction_factor, grace_period) (:63-76)
- `large_large`: PopulationBasedTraining mutating learning_rate and
  weight_decay at perturbation_interval with a burn-in period (:78-94)
- the grace-period heuristic pinned to ≥5000 steps for production runs
  (calculate_grace_period, training/utils.py:119-141; pin at :42)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np


def calculate_grace_period(len_train_set: int, batch_size: int,
                           debug: bool = False) -> int:
    """Reference heuristic (training/utils.py:119-141): at least one epoch's
    steps, pinned to 5000 for production; 1 in debug mode."""
    if debug:
        return 1
    steps_per_epoch = max(math.ceil(len_train_set / max(batch_size, 1)), 1)
    return max(min(steps_per_epoch, 5000), 1)


@dataclasses.dataclass
class AshaScheduler:
    """Asynchronous successive halving over a step-valued time axis.

    Rungs at grace_period * reduction_factor**k. A trial reaching a rung
    continues only if its metric is within the top 1/reduction_factor of
    completed results at that rung.
    """
    metric: str = "eval_loss_wer"
    mode: str = "min"
    max_t: int = 100000
    grace_period: int = 1
    reduction_factor: int = 2

    def __post_init__(self):
        self._rungs: Dict[int, List[float]] = {}
        self._seen: Dict[str, set] = {}
        rung = self.grace_period
        self._rung_levels = []
        while rung < self.max_t:
            self._rung_levels.append(rung)
            rung *= self.reduction_factor

    def _sign(self, value: float) -> float:
        return value if self.mode == "min" else -value

    def on_result(self, trial_id: str, step: int, metrics: Dict[str, float]) -> bool:
        """Returns True to continue, False to stop the trial."""
        if self.metric not in metrics:
            return True
        value = self._sign(float(metrics[self.metric]))
        seen = self._seen.setdefault(trial_id, set())
        decision = True
        for rung in self._rung_levels:
            if step < rung or rung in seen:
                continue
            seen.add(rung)
            recorded = self._rungs.setdefault(rung, [])
            recorded.append(value)
            if len(recorded) < self.reduction_factor:
                continue  # not enough peers yet — optimistic continue
            k = max(len(recorded) // self.reduction_factor, 1)
            cutoff = sorted(recorded)[k - 1]
            if value > cutoff:
                decision = False
        return decision

    def state_dict(self) -> Dict:
        return {"rungs": {str(k): v for k, v in self._rungs.items()},
                "seen": {k: sorted(v) for k, v in self._seen.items()}}

    def load_state_dict(self, sd: Dict):
        self._rungs = {int(k): list(v) for k, v in sd.get("rungs", {}).items()}
        self._seen = {k: set(v) for k, v in sd.get("seen", {}).items()}


@dataclasses.dataclass
class PbtScheduler:
    """Population Based Training policy over segment boundaries.

    The controller trains the population in segments of
    perturbation_interval steps; at each boundary the bottom quantile clones
    the checkpoint of a top-quantile member and perturbs its mutable
    hyperparameters (reference mutates learning_rate and weight_decay,
    ray_searchers_and_schedulers.py:84-92).
    """
    metric: str = "eval_loss_wer"
    mode: str = "min"
    perturbation_interval: int = 10
    burn_in_period: int = 1
    quantile_fraction: float = 0.25
    mutable: tuple = ("learning_rate", "weight_decay")
    perturb_factors: tuple = (0.8, 1.25)

    def exploit_explore(self, rng: np.random.Generator,
                        population: List[Dict]) -> List[Dict]:
        """population: [{trial_id, metric, hp, checkpoint_dir}] →
        [{trial_id, hp, clone_from or None}] decisions."""
        sign = 1.0 if self.mode == "min" else -1.0
        ranked = sorted(population, key=lambda p: sign * p["metric"])
        n = len(ranked)
        k = max(int(n * self.quantile_fraction), 1)
        top, bottom = ranked[:k], ranked[n - k:] if n > 1 else []
        decisions = []
        for p in population:
            d = {"trial_id": p["trial_id"], "hp": dict(p["hp"]), "clone_from": None}
            if any(b["trial_id"] == p["trial_id"] for b in bottom) and top:
                src = top[int(rng.integers(len(top)))]
                d["clone_from"] = src["trial_id"]
                d["hp"] = dict(src["hp"])
                for key in self.mutable:
                    if key in d["hp"]:
                        factor = self.perturb_factors[int(rng.integers(2))]
                        d["hp"][key] = float(d["hp"][key]) * factor
            decisions.append(d)
        return decisions

"""Checkpoint / resume for the port: full state or adapters only,
metric-scored retention, step-exact resume.

Counterpart of asr_finetune_tpu/training/checkpoint.py (`CheckpointManager`
:29), whose semantics it keeps:
- `save(step, state, metrics)` every save_steps and at the end; a save of a
  step already saved is a no-op (returns False);
- retention: with a metric, the `max_to_keep` best by it (min or max) plus
  every checkpoint saved without metrics (orbax's BestN with
  keep_checkpoints_without_metrics), else the `max_to_keep` newest;
- `latest_step`, `all_steps`, `best_step`, `restore(state_like, step)`;
  `restore_trees(trees, step)` loads only the model trees (params,
  adapters, rank mask) into live tensors, as the offline evaluator needs,
  without an optimizer state to restore into.

Storage is `torch.save`, not Orbax (not on the card's machine): one
directory per step, `state.pt` with the step, the optimizer count, every
parameter and moment tensor by its tree path ("mu"/"nu" keyed by the paths
the optimizer trains) and, in PEFT, the "adapters", "sensitivity" and
"rank_mask" trees by path; and `metrics.json`. `adapter_only` (the JAX
manager's option, :53-58, :77-89; the reference's SavePeftModelCallback)
drops the frozen base "params": a restore then leaves the live base as it
is. A save is written to a temporary directory and renamed, so a crash never
leaves a half checkpoint that `latest_step` would pick. Port checkpoints do
not load in the JAX package. Restore copies into the live tensors in place,
so the parameters keep their identity (and requires_grad).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from .optim import leaves

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
TREES = ("params", "adapters", "sensitivity", "rank_mask")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2,
                 metric: Optional[str] = None, mode: str = "min",
                 adapter_only: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.metric = metric
        self.minimize = mode in ("min", "minimize")
        self.adapter_only = adapter_only

    def _trees(self, state: Dict[str, Any]) -> List[str]:
        """The trees of `state` a checkpoint holds."""
        return [t for t in TREES if state.get(t) is not None
                and not (t == "params" and self.adapter_only)]

    # ------------------------------------------------------------- queries

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, STATE_FILE)):
                out.append(int(name[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The best checkpoint by the metric (orbax's best_step); the latest
        when the manager has no metric or no checkpoint was scored."""
        scored = [(s, st) for st in self.all_steps()
                  if self.metric and (s := self._score(st)) is not None]
        return min(scored)[1] if scored else self.latest_step()

    def metrics(self, step: int) -> Optional[Dict[str, float]]:
        path = os.path.join(_step_dir(self.directory, step), METRICS_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f) or None

    def _score(self, step: int) -> Optional[float]:
        m = self.metrics(step)
        if m is None or self.metric not in m:
            return None
        return m[self.metric] if self.minimize else -m[self.metric]

    # --------------------------------------------------------------- save

    def save(self, step: int, state: Dict[str, Any],
             metrics: Optional[Dict[str, float]] = None) -> bool:
        if step in self.all_steps():
            return False
        final = _step_dir(self.directory, step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        opt = state["opt_state"]
        payload = {
            "step": int(state["step"]),
            "opt_count": int(opt["count"]),
            "mu": dict(zip(opt["names"], opt["mu"])),
            "nu": dict(zip(opt["names"], opt["nu"])),
            **{t: {k: p.detach() for k, p in leaves(state[t])}
               for t in self._trees(state)},
        }
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METRICS_FILE), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        os.replace(tmp, final)
        self._prune()
        return True

    def _prune(self) -> None:
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        if self.metric:
            scored = sorted((s, st) for st in steps
                            if (s := self._score(st)) is not None)
            keep = {st for _, st in scored[: self.max_to_keep]}
            keep |= {st for st in steps if self._score(st) is None}
        else:
            keep = set(steps[-self.max_to_keep:])
        for st in steps:
            if st not in keep:
                shutil.rmtree(_step_dir(self.directory, st), ignore_errors=True)

    # ------------------------------------------------------------ restore

    def _load(self, step: Optional[int], device) -> tuple:
        """(step, saved payload) of checkpoint `step`, default the latest."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(_step_dir(self.directory, step), STATE_FILE)
        return step, torch.load(path, map_location=device, weights_only=True)

    def restore(self, state_like: Dict[str, Any],
                step: Optional[int] = None) -> Dict[str, Any]:
        """Load `step` (default: the latest) into state_like's tensors in
        place; returns state_like."""
        opt = state_like["opt_state"]
        _, saved = self._load(step, opt["mu"][0].device)
        with torch.no_grad():
            for t in self._trees(state_like):
                for k, p in leaves(state_like[t]):
                    p.copy_(saved[t][k])
            for k, m, v in zip(opt["names"], opt["mu"], opt["nu"]):
                m.copy_(saved["mu"][k])
                v.copy_(saved["nu"][k])
        opt["count"] = saved["opt_count"]
        state_like["step"] = saved["step"]
        return state_like

    def restore_trees(self, trees: Dict[str, Any], step: Optional[int] = None) -> int:
        """Load the named trees of checkpoint `step` (default: the latest)
        into `trees`' tensors in place (each cast to its tensor's dtype);
        returns the step. Raises KeyError for a tree the checkpoint lacks."""
        step, saved = self._load(step, "cpu")
        with torch.no_grad():
            for t, tree in trees.items():
                if t not in saved:
                    raise KeyError(f"checkpoint of step {step} holds no {t!r} "
                                   f"(it holds {sorted(saved)})")
                for k, p in leaves(tree):
                    p.copy_(saved[t][k])
        return step


def save_trial_manifest(directory: str, payload: Dict[str, Any]) -> None:
    """Reproducibility sidecar: the run's result, hp overrides and flags."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "trial_manifest.json"), "w") as f:
        json.dump(payload, f, indent=2, default=str)

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

In a process group (parallel/) a checkpoint is the whole state, whatever
the world size and --tp: every rank takes part in gathering the
ZeRO-split moments over the data group and the tensor-parallel slices of
the parameters and their moments over the model group, leaf by leaf;
rank 0 writes, and a barrier ends the save; on restore every rank reads
the file and takes its own slices. So the files are those of one process,
and a run saved at one world size or tp resumes at another. The ranks
share the checkpoint directory (one host, or a shared filesystem); what a
rank finds there is rank 0's answer.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from ..parallel import mesh, sharding
from .optim import leaves

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
TREES = ("params", "adapters", "sensitivity", "rank_mask")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _shards(opt: Dict[str, Any]) -> list:
    """Each moment's LeafShard; None (whole) where the state has none."""
    return opt.get("shards") or [None] * len(opt["names"])


def _splits(opt: Dict[str, Any]) -> list:
    """Whether each moment is a tensor-parallel slice (False where the state
    does not say)."""
    return opt.get("tp_split") or [False] * len(opt["names"])


def _whole(opt: Dict[str, Any], key: str) -> Dict[str, torch.Tensor]:
    """Moment `key` of every leaf, whole: a split leaf gathered over the
    data group, then over the model group, one at a time, and kept on the
    host by rank 0 only."""
    out = {}
    for k, s, split, m in zip(opt["names"], _shards(opt), _splits(opt), opt[key]):
        zero = s is not None and s.axis is not None
        if not (zero or split):
            out[k] = m
            continue
        full = s.gather(m) if zero else m
        full = sharding.gathered(k, full, host=True) if split else full
        if mesh.is_primary():
            out[k] = full.cpu()
    return out


def _whole_tree(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Every leaf of a model tree by path, whole: under tp the split leaves
    gathered over the model group (rank 0 keeps them, on the host)."""
    out = {}
    for k, p in leaves(tree):
        p = p.detach()
        full = sharding.gathered(k, p, host=True)
        if full is p:
            out[k] = p
        elif mesh.is_primary():
            out[k] = full
    return out


def _local(path: str, t: torch.Tensor, split: bool = True) -> torch.Tensor:
    """This rank's tensor-parallel slice of a whole saved leaf, or t."""
    if not split:
        return t
    return sharding.local_slice(path, t, mesh.model_rank(), mesh.model_world())


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
        """Write checkpoint `step` (rank 0; every rank of a group calls it).
        Returns False, writing nothing, when that step is already saved."""
        if mesh.broadcast_object(step in self.all_steps()):
            return False
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()   # offloaded moments: their copies landed
        opt = state["opt_state"]
        whole = {key: _whole(opt, key) for key in ("mu", "nu")}
        trees = {t: _whole_tree(state[t]) for t in self._trees(state)}
        if mesh.is_primary():
            final = _step_dir(self.directory, step)
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            payload = {
                "step": int(state["step"]),
                "opt_count": int(opt["count"]),
                **whole,
                **trees,
            }
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
            os.replace(tmp, final)
            self._prune()
        mesh.barrier()
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
                    # under tp only the parameters are split
                    p.copy_(_local(k, saved[t][k], t == "params"))
            for k, s, split, m, v in zip(opt["names"], _shards(opt), _splits(opt),
                                         opt["mu"], opt["nu"]):
                for held, key in ((m, "mu"), (v, "nu")):
                    part = _local(k, saved[key][k], split)
                    held.copy_(part if s is None else s.of(part))
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


def load_trial_manifest(directory: str) -> Optional[Dict[str, Any]]:
    """The sidecar save_trial_manifest wrote in `directory`, None if none."""
    path = os.path.join(directory, "trial_manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)

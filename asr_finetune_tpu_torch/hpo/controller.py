"""HPO controller: trials, schedulers, manifest-based resume (PyTorch port).

Counterpart of asr_finetune_tpu/hpo/controller.py, which replaces the
reference's Ray Tune layer (train_hyper.py:312-394) with a slim
single-controller loop, and keeps its files and decisions:

- the searcher suggests hp configs (hpo/search.py; space from
  hpo/space.py); its state (RNG and observations) lives in
  searcher_state.json, so a resumed experiment suggests what an
  uninterrupted one would
- each trial runs via run.run_trial
- ASHA early-stops through the trainer's on_evaluate hook; its rungs live
  in scheduler_state.json
- PBT mode trains the population in perturbation_interval segments using
  checkpoint clone + hp perturbation (hpo/schedulers.py)
- experiment state lives in experiment_state.json: completed trials are
  skipped on resume, errored/unfinished re-run (reference
  Tuner.restore(resume_unfinished=True, resume_errored=True),
  train_hyper.py:349-353); per-trial error.txt mirrors Ray's error files
- best-trial summary saved like best_result.npy (train_hyper.py:390-394)

Trial packing (--chips_per_trial, --max_concurrent_trials; JAX :119-207,
the reference's fractional gpus_per_trial): the port runs one process per
card, so a slot is a set of ranks of one host (parallel/mesh.trial_groups,
with --tp inside the slot), and each slot runs trials in a trial group of
its own. The trials' indices are taken in order by whichever slot is free.
The files are the experiment's shared state, guarded by an fcntl lock on
`<exp_dir>/.hpo.lock` when more than one slot runs: the slot's leader
claims the next index (trial_queue.json), suggests (searcher_state.json),
records (experiment_state.json), takes each ASHA decision
(scheduler_state.json) and records the result, each time re-reading the
file it changes under the lock, and broadcasts the hp and the decisions
over its trial group. A trial that every rank of its slot ends, returned
or raised, is isolated (recorded errored with its error.txt) and the slot
goes on. A rank that dies ends the experiment: its slot's collectives and
the final wait raise. Once the queue is empty, every rank waits for the
others (mesh.final_wait) and the summary is read from
experiment_state.json. One process with several cards does not pack: it
raises, naming the torchrun launch that does. PBT runs its population one
member at a time over the whole group, as in JAX.
"""
from __future__ import annotations

import contextlib
import copy
import fcntl
import json
import logging
import os
import shutil
import traceback
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import run as run_lib
from ..device import resolve_device
from ..parallel import mesh
from ..utils.logging_utils import setup_logging
from .schedulers import AshaScheduler, PbtScheduler, calculate_grace_period
from .search import make_searcher
from .space import get_whisper_hyperparameters

logger = logging.getLogger(__name__)


def _write_json(path: str, obj: Any, **kw) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, **kw)
    os.replace(tmp, path)


def _read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


class ExperimentState:
    def __init__(self, path: str):
        self.path = path
        self.trials: Dict[str, Dict[str, Any]] = {}
        self.reload()

    def reload(self):
        """Re-read the file (another slot's leader may have written it)."""
        if os.path.exists(self.path):
            self.trials = _read_json(self.path).get("trials", {})

    def save(self):
        if not mesh.is_primary():
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        _write_json(self.path, {"trials": self.trials}, indent=2, default=str)

    def record(self, trial_id: str, **kw):
        self.trials.setdefault(trial_id, {}).update(kw)
        self.save()


def _metric_cfg(args):
    metric = "eval_loss_wer"
    mode = "min"
    if args.metric_to_optimize:
        flat = [m for group in args.metric_to_optimize for m in group]
        if flat:
            metric = flat[0]
    if args.modes:
        flat = [m for group in args.modes for m in group]
        if flat:
            mode = flat[0]
    return metric, mode


def count_slots(args) -> int:
    """The number of trials this run packs at once (JAX controller.py:
    123-140, over the ranks of this host: parallel/mesh.trial_slots). One
    process with several cards raises: the port runs one process per card,
    and packing over n cards is a launch of n ranks."""
    resolve_device(args.device)       # no card and no --device cpu: raise here
    if not mesh.active():
        n_cards = 1 if torch.device(args.device).type == "cpu" else torch.cuda.device_count()
        n_slots = len(mesh.slot_plan(n_cards, args.chips_per_trial,
                                     args.max_concurrent_trials))
        if n_slots > 1:
            raise ValueError(
                f"--chips_per_trial {args.chips_per_trial} packs {n_slots} trials onto the "
                f"{n_cards} cards of one process: the port runs one process per card, so "
                f"pack them over ranks: torchrun --nproc_per_node {n_cards} -m "
                "asr_finetune_tpu_torch.cli.train_hyper --chips_per_trial "
                f"{args.chips_per_trial:g} --max_concurrent_trials "
                f"{args.max_concurrent_trials} ...")
    return len(mesh.trial_slots(args.chips_per_trial, args.max_concurrent_trials))


class _Files:
    """The experiment's shared files and the lock that guards them when
    more than one slot runs (`locked`; one slot: its leader alone writes)."""

    def __init__(self, exp_dir: str, shared: bool):
        self.exp_dir = exp_dir
        self.shared = shared
        self.state = ExperimentState(os.path.join(exp_dir, "experiment_state.json"))
        self.searcher = os.path.join(exp_dir, "searcher_state.json")
        self.scheduler = os.path.join(exp_dir, "scheduler_state.json")
        self.queue = os.path.join(exp_dir, "trial_queue.json")
        self.lock = os.path.join(exp_dir, ".hpo.lock")

    @contextlib.contextmanager
    def locked(self) -> Iterator[None]:
        if not self.shared:
            yield
            return
        with open(self.lock, "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)


def run_experiment(args) -> Dict[str, Any]:
    setup_logging(logging.DEBUG if args.debug else logging.INFO)
    count_slots(args)
    exp_dir = os.path.join(args.storage_path, args.output_tag)
    os.makedirs(exp_dir, exist_ok=True)
    metric, mode = _metric_cfg(args)
    space = get_whisper_hyperparameters(args)
    if args.search_schedule_mode == "large_large":
        run_lib.check_parallel_layout(args)
        state = ExperimentState(os.path.join(exp_dir, "experiment_state.json"))
        mesh.barrier()   # every rank has read the experiment before rank 0 writes
        return _run_pbt(args, state, space, exp_dir, metric, mode)
    with mesh.trial_groups(args.chips_per_trial, args.max_concurrent_trials,
                           args.tp) as slots:
        files = _Files(exp_dir, shared=len(slots) > 1)
        _start(args, files, space, metric, mode)
        mesh.global_barrier()   # the files are ready before any slot reads them
        if mesh.trial_slot() is not None:
            while _run_next(args, files, space, metric, mode):
                pass
        mesh.final_wait()
    summary = None
    if mesh.is_experiment_primary():
        # the summary from the file every slot recorded its trials in
        files.state.reload()
        trials = [(f"trial_{i:04d}", files.state.trials.get(f"trial_{i:04d}", {}))
                  for i in range(args.num_samples)]
        results = [(tid, rec["result"]) for tid, rec in trials
                   if rec.get("status") == "completed"]
        summary = _finalize(exp_dir, files.state, results, metric, mode)
    return mesh.broadcast_object(summary)


def _searcher(args, space, mode):
    return make_searcher(args.search_schedule_mode, space, seed=args.random_seed,
                         metric_mode=mode)


def _asha(args, metric, mode) -> AshaScheduler:
    grace = args.grace_period or calculate_grace_period(
        args.len_train_set, args.per_device_train_batch_size, args.debug)
    return AshaScheduler(metric=metric, mode=mode, max_t=args.max_t or args.max_steps,
                         grace_period=grace, reduction_factor=args.reduction_factor)


def _start(args, files: _Files, space, metric, mode) -> None:
    """The experiment's rank 0 writes the searcher and scheduler states the
    trials start from and an empty queue. With --resume_training they are
    the saved ones (exact searcher resume: its RNG and observations, so a
    resumed experiment suggests the sequence an uninterrupted one would);
    else a new scheduler and a searcher that has observed the completed
    trials of experiment_state.json."""
    if not mesh.is_experiment_primary():
        return
    asha = _asha(args, metric, mode)
    if os.path.exists(files.scheduler) and args.resume_training:
        asha.load_state_dict(_read_json(files.scheduler))
    searcher = _searcher(args, space, mode)
    if os.path.exists(files.searcher) and args.resume_training:
        searcher.load_state_dict(_read_json(files.searcher))
    else:
        for rec in files.state.trials.values():
            if rec.get("status") == "completed" and metric in rec.get("result", {}):
                searcher.observe(rec["hp"], rec["result"][metric])
    _write_json(files.scheduler, asha.state_dict())
    _write_json(files.searcher, searcher.state_dict())
    _write_json(files.queue, {"next": 0})


def _claim(args, files: _Files, space, mode) -> Optional[Tuple[int, Dict, bool]]:
    """Under the lock: the next trial index of the queue, skipping a
    completed trial on resume; its hp (the saved one on resume, else the
    searcher's next suggestion), recorded running. (index, hp, resumed) or
    None once the queue is empty."""
    with files.locked():
        queue = _read_json(files.queue)
        files.state.reload()
        claim = None
        while claim is None and queue["next"] < args.num_samples:
            i = queue["next"]
            queue["next"] += 1
            trial_id = f"trial_{i:04d}"
            rec = files.state.trials.get(trial_id)
            if rec and rec.get("status") == "completed" and args.resume_training:
                continue
            if rec and "hp" in rec and args.resume_training:
                hp = rec["hp"]
            else:
                searcher = _searcher(args, space, mode)
                searcher.load_state_dict(_read_json(files.searcher))
                hp = searcher.suggest()
                _write_json(files.searcher, searcher.state_dict())
            files.state.record(trial_id, hp=hp, status="running")
            claim = (i, hp, bool(rec and args.resume_training))
        _write_json(files.queue, queue)
    return claim


def _run_next(args, files: _Files, space, metric, mode) -> bool:
    """Claim the next trial for this slot (its leader, broadcast over the
    trial group) and run it on every rank of the slot; False once the
    queue is empty."""
    claim = _claim(args, files, space, mode) if mesh.is_primary() else None
    claim = mesh.broadcast_object(claim)
    if claim is None:
        return False
    i, hp, resumed = claim
    trial_id = f"trial_{i:04d}"
    trial_dir = os.path.join(files.exp_dir, trial_id)
    logger.info("=== %s hp=%s", trial_id, hp)
    trial_args = copy.deepcopy(args)
    if "per_device_train_batch_size" in hp:
        trial_args.per_device_train_batch_size = int(hp["per_device_train_batch_size"])

    def on_eval(step, metrics):
        # the leader decides; the trainer broadcasts its decision over the slot
        if not mesh.is_primary():
            return True
        with files.locked():
            asha = _asha(args, metric, mode)
            asha.load_state_dict(_read_json(files.scheduler))
            go = asha.on_result(trial_id, step, metrics)
            _write_json(files.scheduler, asha.state_dict())
        return go

    try:
        result = run_lib.run_trial(trial_args, hp=hp, trial_dir=trial_dir,
                                   on_evaluate=on_eval, resume_override=resumed,
                                   trial_index=i)
        outcome = ("completed", result)
    except Exception as e:  # noqa: BLE001 — per-trial fault isolation
        logger.exception("%s errored", trial_id)
        outcome = ("errored", (str(e), traceback.format_exc()))
    # every rank of the slot ended the trial: the slot agrees on its outcome
    outcomes = mesh.all_gather_object(outcome)
    errors = [o[1] for o in outcomes if o[0] == "errored"]
    if mesh.is_primary():
        with files.locked():
            files.state.reload()
            if errors:
                os.makedirs(trial_dir, exist_ok=True)
                with open(os.path.join(trial_dir, "error.txt"), "a") as f:
                    f.write("".join(tb for _, tb in errors))
                files.state.record(trial_id, status="errored", error=errors[0][0])
            else:
                files.state.record(trial_id, status="completed", result=result)
                if metric in result:
                    searcher = _searcher(args, space, mode)
                    searcher.load_state_dict(_read_json(files.searcher))
                    searcher.observe(hp, result[metric])
                    _write_json(files.searcher, searcher.state_dict())
    return True


def _run_pbt(args, state: ExperimentState, space, exp_dir, metric, mode
             ) -> Dict[str, Any]:
    """Population Based Training: segments + exploit/explore."""
    rng = np.random.default_rng(args.random_seed)
    pbt = PbtScheduler(metric=metric, mode=mode,
                       perturbation_interval=args.perturbation_interval,
                       burn_in_period=args.burn_in_period)
    pop_size = args.num_samples
    population = []
    for i in range(pop_size):
        tid = f"pbt_{i:04d}"
        rec = state.trials.get(tid, {})
        hp = rec.get("hp") or {k: d.sample(rng) for k, d in space.items()}
        population.append({"trial_id": tid, "hp": hp, "metric": float("inf"),
                           "steps": int(rec.get("steps", 0))})
        state.record(tid, hp=hp, status="initialized")

    seg = args.perturbation_interval
    total = args.max_steps
    while min(p["steps"] for p in population) < total:
        for member_i, p in enumerate(population):
            if p["steps"] >= total:
                continue
            target = min(p["steps"] + seg, total)
            trial_dir = os.path.join(exp_dir, p["trial_id"])
            trial_args = copy.deepcopy(args)
            try:
                result = run_lib.run_trial(
                    trial_args, hp=p["hp"], trial_dir=trial_dir,
                    max_steps_override=target,
                    resume_override=p["steps"] > 0, trial_index=member_i)
                p["steps"] = target
                p["metric"] = float(result.get(metric, float("inf")))
                state.record(p["trial_id"], status="running",
                             steps=target, result=result)
            except Exception as e:  # noqa: BLE001
                logger.exception("%s errored", p["trial_id"])
                state.record(p["trial_id"], status="errored", error=str(e))
                if mesh.world() > 1:
                    raise
                p["steps"] = target  # don't wedge the loop on one bad member
        if min(p["steps"] for p in population) >= args.burn_in_period * seg:
            decisions = pbt.exploit_explore(rng, [
                {**p, "checkpoint_dir": os.path.join(exp_dir, p["trial_id"])}
                for p in population])
            for p, d in zip(population, decisions):
                if d["clone_from"]:
                    src_ckpt = os.path.join(exp_dir, d["clone_from"], "checkpoints")
                    dst_ckpt = os.path.join(exp_dir, p["trial_id"], "checkpoints")
                    if os.path.exists(src_ckpt) and mesh.is_primary():
                        shutil.rmtree(dst_ckpt, ignore_errors=True)
                        shutil.copytree(src_ckpt, dst_ckpt)
                    mesh.barrier()
                    logger.info("PBT: %s exploits %s with hp=%s",
                                p["trial_id"], d["clone_from"], d["hp"])
                p["hp"] = d["hp"]
                state.record(p["trial_id"], hp=p["hp"],
                             cloned_from=d["clone_from"])

    results = [(p["trial_id"], {"final_step": p["steps"], metric: p["metric"]})
               for p in population]
    return _finalize(exp_dir, state, results, metric, mode)


def _finalize(exp_dir, state, results, metric, mode) -> Dict[str, Any]:
    scored = [(tid, r) for tid, r in results if metric in r]
    if not scored:
        logger.warning("no trial produced metric %s", metric)
        return {"best_trial": None, "results": dict(results)}
    sign = 1.0 if mode == "min" else -1.0
    best_tid, best = min(scored, key=lambda x: sign * x[1][metric])
    summary = {"best_trial": best_tid, "best_result": best,
               "metric": metric, "mode": mode,
               "hp": state.trials.get(best_tid, {}).get("hp")}
    # best_result.npy analogue (train_hyper.py:390-394) + readable JSON
    if mesh.is_experiment_primary():
        np.save(os.path.join(exp_dir, "best_result.npy"), summary)  # type: ignore
        with open(os.path.join(exp_dir, "best_result.json"), "w") as f:
            json.dump(summary, f, indent=2, default=str)
    logger.info("best trial %s: %s", best_tid, best)
    return summary

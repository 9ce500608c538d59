"""HPO controller: trials, schedulers, manifest-based resume (PyTorch port).

Counterpart of asr_finetune_tpu/hpo/controller.py, which replaces the
reference's Ray Tune layer (train_hyper.py:312-394) with a slim
single-controller loop, and keeps its files and decisions:

- the searcher suggests hp configs (hpo/search.py; space from
  hpo/space.py); its state (RNG and observations) lives in
  searcher_state.json, so a resumed experiment suggests what an
  uninterrupted one would
- each trial runs via run.run_trial, one after another on the card
- ASHA early-stops through the trainer's on_evaluate hook; its rungs live
  in scheduler_state.json
- PBT mode trains the population in perturbation_interval segments using
  checkpoint clone + hp perturbation (hpo/schedulers.py)
- experiment state lives in experiment_state.json: completed trials are
  skipped on resume, errored/unfinished re-run (reference
  Tuner.restore(resume_unfinished=True, resume_errored=True),
  train_hyper.py:349-353); per-trial error.txt mirrors Ray's error files
- best-trial summary saved like best_result.npy (train_hyper.py:390-394)

The JAX controller packs trials onto disjoint chip subsets
(`chips_per_trial`). The port counts cards with torch.cuda.device_count()
(1 on --device cpu) and runs one trial at a time on one card; a
configuration that would open more than one slot raises
NotImplementedError rather than run its trials one after another.

In a process group (parallel/mesh.py) every rank runs this controller and
takes part in every trial, one after another over the whole group, as the
JAX controller does over hosts (:131-133); under --tp a trial spans the
whole data x tp group too, each rank holding its slice of the model. The searcher, scheduler and
PBT decisions agree on every rank because the metrics do; rank 0 alone
writes the experiment's files (experiment, scheduler and searcher state,
best_result, error.txt). A trial that raises on a rank ends the
experiment there: the other ranks would wait in its collectives.
"""
from __future__ import annotations

import copy
import json
import logging
import os
import shutil
import traceback
from typing import Any, Dict

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


class ExperimentState:
    def __init__(self, path: str):
        self.path = path
        self.trials: Dict[str, Dict[str, Any]] = {}
        if os.path.exists(path):
            with open(path) as f:
                self.trials = json.load(f).get("trials", {})

    def save(self):
        if not mesh.is_primary():
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"trials": self.trials}, f, indent=2, default=str)
        os.replace(tmp, self.path)

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
    """The number of trials the JAX controller would run at once on this
    host's cards (controller.py:123-140). The port runs one: more raises.
    In a process group every trial spans the group (data and --tp ranks):
    one slot."""
    resolve_device(args.device)       # no card and no --device cpu: raise here
    if mesh.world() > 1:
        return 1
    n_cards = 1 if torch.device(args.device).type == "cpu" else torch.cuda.device_count()
    chips = int(args.chips_per_trial) if args.chips_per_trial else 0
    n_slots = 1
    if chips and chips < n_cards:
        n_slots = min(n_cards // chips, max(args.max_concurrent_trials, 1))
    if n_slots > 1:
        raise NotImplementedError(
            f"--chips_per_trial {args.chips_per_trial} would run {n_slots} trials at "
            f"once on {n_cards} cards: packing trials over cards is not ported yet "
            "(the port runs one trial at a time on one card)")
    return n_slots


def run_experiment(args) -> Dict[str, Any]:
    setup_logging(logging.DEBUG if args.debug else logging.INFO)
    count_slots(args)
    run_lib.check_parallel_layout(args)
    exp_dir = os.path.join(args.storage_path, args.output_tag)
    os.makedirs(exp_dir, exist_ok=True)
    state = ExperimentState(os.path.join(exp_dir, "experiment_state.json"))
    mesh.barrier()   # every rank has read the experiment before rank 0 writes
    metric, mode = _metric_cfg(args)
    space = get_whisper_hyperparameters(args)
    searcher = make_searcher(args.search_schedule_mode, space,
                             seed=args.random_seed, metric_mode=mode)

    if args.search_schedule_mode == "large_large":
        return _run_pbt(args, state, space, exp_dir, metric, mode)

    grace = args.grace_period or calculate_grace_period(
        args.len_train_set, args.per_device_train_batch_size, args.debug)
    asha = AshaScheduler(metric=metric, mode=mode, max_t=args.max_t or args.max_steps,
                         grace_period=grace,
                         reduction_factor=args.reduction_factor)
    sched_path = os.path.join(exp_dir, "scheduler_state.json")
    if os.path.exists(sched_path) and args.resume_training:
        with open(sched_path) as f:
            asha.load_state_dict(json.load(f))

    # exact searcher resume: restore RNG + observation history so a resumed
    # experiment suggests the same sequence an uninterrupted one would.
    # Falls back to replaying completed trials for experiments saved without
    # a searcher state.
    searcher_path = os.path.join(exp_dir, "searcher_state.json")
    if os.path.exists(searcher_path) and args.resume_training:
        with open(searcher_path) as f:
            searcher.load_state_dict(json.load(f))
    else:
        for tid, rec in state.trials.items():
            if rec.get("status") == "completed" \
                    and metric in rec.get("result", {}):
                searcher.observe(rec["hp"], rec["result"][metric])
    mesh.barrier()   # every rank has read the searcher and scheduler state

    def save_searcher():
        if not mesh.is_primary():
            return
        tmp = searcher_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(searcher.state_dict(), f)
        os.replace(tmp, searcher_path)

    results = []

    def run_one(i: int):
        trial_id = f"trial_{i:04d}"
        rec = state.trials.get(trial_id)
        if rec and rec.get("status") == "completed" and args.resume_training:
            results.append((trial_id, rec["result"]))
            return
        if rec and "hp" in rec and args.resume_training:
            hp = rec["hp"]
        else:
            hp = searcher.suggest()
            save_searcher()  # suggest advances the RNG stream
        state.record(trial_id, hp=hp, status="running")
        trial_dir = os.path.join(exp_dir, trial_id)
        logger.info("=== %s hp=%s", trial_id, hp)

        trial_args = copy.deepcopy(args)
        if "per_device_train_batch_size" in hp:
            trial_args.per_device_train_batch_size = int(
                hp["per_device_train_batch_size"])

        def on_eval(step, metrics, _tid=trial_id):
            return asha.on_result(_tid, step, metrics)

        try:
            result = run_lib.run_trial(
                trial_args, hp=hp, trial_dir=trial_dir, on_evaluate=on_eval,
                resume_override=bool(rec and args.resume_training),
                trial_index=i)
            state.record(trial_id, status="completed", result=result)
            if metric in result:
                searcher.observe(hp, result[metric])
                save_searcher()
            results.append((trial_id, result))
        except Exception as e:  # noqa: BLE001 — per-trial fault isolation
            logger.exception("%s errored", trial_id)
            if mesh.is_primary():
                os.makedirs(trial_dir, exist_ok=True)
                with open(os.path.join(trial_dir, "error.txt"), "a") as f:
                    f.write(traceback.format_exc())
            state.record(trial_id, status="errored", error=str(e))
            if mesh.world() > 1:
                raise
        finally:
            if mesh.is_primary():
                with open(sched_path, "w") as f:
                    json.dump(asha.state_dict(), f)

    for i in range(args.num_samples):
        run_one(i)

    return _finalize(exp_dir, state, results, metric, mode)


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
    if mesh.is_primary():
        np.save(os.path.join(exp_dir, "best_result.npy"), summary)  # type: ignore
        with open(os.path.join(exp_dir, "best_result.json"), "w") as f:
            json.dump(summary, f, indent=2, default=str)
    logger.info("best trial %s: %s", best_tid, best)
    return summary

"""Training cells: the port's Trainer.train, timed as it runs.

Set-up builds one trial with run.setup_trial (model, the int8 base and its
calibration, AdamW, the data pipeline over an audiofolder of the seed's
utterances, the Trainer) from the program's own options, which the traffic
file lists, with the benchmark's weights and adapters put in the place of
the port's random init (the configuration's family module, families.py,
gives them and the reference's settings). Then Trainer.train runs once.
Light wrappers of its train iterator and its step call record the spans;
its first `check_steps` steps are the warm-up, and what the correctness
check reads is taken from them: each step's loss, the first gradient from
AdamW's first moment after step 1, the change of every trained leaf after
the last. The window follows in the same call, from that state, with all
the trainer does between steps (its logging every logging_steps; eval and
checkpoints where the options ask for them inside the window). When the
window's time is up, and after the traced window with --trace 1, the step
wrapper ends the call.

After the window the program is freed and the family's reference
(reference.py for Whisper) recomputes the checked steps from the seed,
with the settings read from the same parsed options.
"""
from __future__ import annotations

import gc
import math
import os
import statistics
import tempfile
import time
from typing import Any, Dict, List

import numpy as np

from . import families
from . import harness as H
from . import traffic as TR

ADAM_B1 = 0.9


class Window:
    """What a per-layer reader of a training cell reads."""
    kind = "train"

    def __init__(self, family, n, batch, label_len, mode):
        self.family = family          # the configuration's family module
        self.n, self.batch, self.label_len, self.mode = n, batch, label_len, mode
        self.spans = H.Spans()
        self.returns: List[float] = []
        self.steps = 0
        self.utterances = 0
        self.window_s = 0.0
        self.peak_bytes = 0
        self.trace = None             # harness.Trace of the traced part
        self.calls = None             # harness.Calls of the traced part
        self.traced_steps = 0
        self.failed = 0               # steps whose loss is not finite
        self.host = H.HostMeter()     # the host over the (untraced) window


def program_argv(cell, seed, pool_dir, val_dir, out_dir, device) -> List[str]:
    """The program's options: the data, batch, seed and output the run
    gives, then the traffic file's options."""
    tr = cell["traffic"]
    return ["--device", str(device), "--model_type", cell["config"]["model_type"],
            "--data_mode", "folder", "--dataset_name", pool_dir, "--val_dataset_name", val_dir,
            "--per_device_train_batch_size", str(tr["batch"]), "--random_seed", str(seed),
            "--output_dir", out_dir, "--output_tag", "bench"] + list(tr["train"]["options"])


def parse_program_args(cell, seed, device="cuda", dirs=("", "", "")):
    from asr_finetune_tpu_torch import config as PC
    return PC.parse_args(program_argv(cell, seed, *dirs, device))


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


class WindowClosed(Exception):
    """Raised by the step wrapper once the run's windows are over: it ends
    Trainer.train (before the trainer's closing checkpoint)."""


class _TimedIter:
    """The trainer's train iterator, with next() timed and the checked
    steps' rows recorded."""

    def __init__(self, inner, drv):
        self.inner, self.drv = inner, drv

    def __iter__(self):
        return self

    def __next__(self):
        a = time.perf_counter()
        batch = next(self.inner)
        b = time.perf_counter()
        d = self.drv
        if d.phase == "check":
            d.rows.append([int(i) for i in np.asarray(batch["idx"])])
        else:
            d.spans.add("data wait", a, b)
        return batch

    def close(self):
        if hasattr(self.inner, "close"):
            self.inner.close()


class Driver:
    """Wraps the trainer's train_iter and _train_step: the checked steps,
    then the window of `seconds`, then with trace the traced window."""

    def __init__(self, trainer, step, w: Window, seconds, trace, check_steps, torch, ph,
                 out_dir):
        self.trainer, self.step, self.w = trainer, step, w
        self.seconds, self.trace, self.check_steps = seconds, trace, check_steps
        self.torch, self.ph, self.out_dir = torch, ph, out_dir
        self.cuda = trainer.device.type == "cuda"
        self.phase = "check"
        self.rows: List[List[int]] = []
        self.losses: List[Any] = []
        self.first_grad = self.change = self.outlier_sets = None
        self.label_len = 0
        self.setup_s = 0.0
        self.pending: List[Any] = []       # the window's losses, read after it
        self.spans, self.returns = w.spans, w.returns
        self.card = None
        factory = trainer.train_iter
        trainer.train_iter = lambda start: _TimedIter(factory(start), self)
        trainer._train_step = self.timed_step

    def timed_step(self, state, batch):
        if self.phase == "check":
            m = self.step(state, batch)
            self.losses.append(m["loss"])
            self.label_len = int(batch["labels"].shape[-1])
            if len(self.losses) == 1:
                self.first_grad = [float((mu / (1 - ADAM_B1)).norm())
                                   for mu in state["opt_state"]["mu"]]
            if len(self.losses) == self.check_steps:
                self._open_window(state)
            return m
        b = time.perf_counter()
        m = self.step(state, batch)
        c = time.perf_counter()
        self.spans.add("step dispatch", b, c)
        self.returns.append(c)
        self.pending.append(m["loss"])
        if self.phase == "window":
            self.w.steps += 1
            self.w.utterances += int(np.prod(batch["labels"].shape[:-1]))
        else:
            self.w.traced_steps += 1
        if c - self.t_open >= self.seconds:
            self._close()
        return m

    def _open_window(self, state):
        names = list(state["opt_state"]["names"])
        tree = state["adapters"] if self.w.mode == "peft" else state["params"]
        start = self.start_tree()
        self.change = [float((_leaf(tree, k).detach() - _leaf(start, k)).norm())
                       for k in names]
        del start
        self.losses = [float(x) for x in self.losses]
        q = self.trainer.step_cfg.quant
        if q is not None and q.static_idx is not None:
            self.outlier_sets = {tuple(k): tuple(v) for k, v in q.static_idx.items()}
        if self.cuda:
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()
        self.ph.mark("warm-up")
        self.setup_s = self.ph.total()
        self.phase = "window"
        self.w.host.start()
        self.t0 = self.t_open = time.perf_counter()

    def _close(self):
        w, torch = self.w, self.torch
        if self.cuda:
            torch.cuda.synchronize()
        if self.phase == "window":
            w.window_s = time.perf_counter() - self.t0
            w.host.stop()
            if self.cuda:
                w.peak_bytes = torch.cuda.max_memory_allocated()
            if self.trace and self.cuda:
                self._open_traced()
                return
        else:
            self._stop_traced()
        raise WindowClosed()

    def _open_traced(self):
        w = self.w
        self.card = H.CardLog(os.path.join(self.out_dir, "card.csv"))
        w.calls, w.trace = H.Calls(), H.Trace()
        w.calls.install()
        self.card.start()
        w.trace_spans = self.spans = H.Spans()
        self.returns = []
        w.trace.start(self.torch)
        self.phase = "traced"
        self.t_open = time.perf_counter()

    def _stop_traced(self):
        if self.phase == "traced" and self.w.trace._prof is not None:
            self.w.trace.stop(self.torch)
        if self.card is not None:
            self.card.stop()
            self.card = None
        if self.w.calls is not None:
            self.w.calls.remove()

    def run(self):
        try:
            self.trainer.train()
        except WindowClosed:
            pass
        finally:
            self._stop_traced()
        if self.phase == "check":
            raise RuntimeError("Trainer.train ended before the window opened")
        self.w.failed = sum(not math.isfinite(float(x)) for x in self.pending)


def run(cell, seed: int, seconds: float, trace: bool, device, ph: H.Phases,
        out_dir: str, faults=()) -> Dict[str, Any]:
    """One run, as run.py describes it; the data pool lives in a temporary
    directory under TMPDIR for the run's length."""
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        return _run(cell, seed, seconds, trace, device, ph, out_dir, faults, tmp)


def _run(cell, seed, seconds, trace, device, ph, out_dir, faults, tmp) -> Dict[str, Any]:
    with ph("import"):
        family = families.load(cell["config"])
        import torch
        from asr_finetune_tpu_torch import run as PR
    cuda = device.type == "cuda"
    with ph("kernels"):
        if cuda:
            from asr_finetune_tpu_torch.ops import _build
            from asr_finetune_tpu_torch.utils import native_ext
            _build.build_all()
            native_ext.load()
    cfg, tr = cell["config"], cell["traffic"]
    n = family.dims(cfg)
    with ph("data pool"):
        pool = TR.make_pool(tr, seed, tr["pool"])
        calib = TR.make_pool(tr, seed, 4, stream=1)
        args = parse_program_args(cell, seed, device, (
            pool.write(os.path.join(tmp, "train")), calib.write(os.path.join(tmp, "val")),
            os.path.join(tmp, "out")))
        opts = family.reference_opts(args, seed)
    peft = opts["mode"] == "peft"

    def start_tree():
        return (family.make_adapters(cfg, opts["lora_rank"], opts["lora_alpha"], seed, device,
                                     encoder=opts["encoder_adapters"])
                if peft else family.make_weights(cfg, seed, device))
    with ph("weights"):
        weights = family.make_weights(cfg, seed, device)
        adapters = start_tree() if peft else None
    for k, v in tr.get("env", {}).items():
        os.environ[k] = str(v)
    with ph("build"):
        with family.injected(weights, adapters):
            trainer = PR.setup_trial(args)
        del weights, adapters
        family.check_program_settings(trainer, opts, tr["check_steps"])
    step = trainer._train_step
    if "unchanged_state" in faults:
        step = _fault_unchanged(step, family.leaves)
    if "half_batch" in faults:
        step = _fault_half_batch(step)

    w = Window(family, n, tr["batch"], 0, opts["mode"])
    drv = Driver(trainer, step, w, seconds, trace, tr["check_steps"], torch, ph, out_dir)
    drv.start_tree = start_tree
    drv.run()
    w.label_len = drv.label_len
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted = w.steps + w.traced_steps

    # the program freed, then the reference
    rows, losses, first_grad, change = drv.rows, drv.losses, drv.first_grad, drv.change
    outlier_sets, setup_s = drv.outlier_sets, drv.setup_s
    del trainer, step, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = family.train_steps(cfg, opts, seed, pool, rows[: tr["check_steps"]], calib, device)
    checks = compare(cell["limits"], losses, first_grad, change, outlier_sets, ref)
    t_ref = time.perf_counter() - t_ref
    return {"attempted": attempted, "failed": w.failed, "checks": checks,
            "metrics": {"train_utt_per_s": w.utterances / w.window_s, "setup_s": setup_s},
            "window": w, "memory_peak_bytes": memory_peak, "reference_s": t_ref}


def _fault_unchanged(step, leaves):
    """A step that returns the metrics and leaves the state as it was."""
    import copy

    def broken(state, batch):
        keep = {k: copy.deepcopy(v) for k, v in state.items() if k in ("params", "adapters")}
        m = step(state, batch)
        for k, v in keep.items():
            for path, leaf in leaves(v):
                _leaf(state[k], path).data.copy_(leaf)
        return m
    return broken


def _fault_half_batch(step):
    """A step over the first half of its rows, the mean over those."""
    def broken(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return broken


def _rel(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor, 1e-30)


def compare(limits, losses, first_grad, change, outlier_sets, ref) -> Dict[str, Dict]:
    """The numbers the cell's limits file names, each beside its limit:
    of the loss at each checked step (the largest relative gap), of the
    first gradient's norm and of the change's norm by the worst leaf (each
    gap over the larger of the reference leaf's norm and the median
    leaf's; leaves whose reference gradient is under a thousandth of the
    median leaf's at every checked step left out), and of the calibrated
    outlier columns (how many differ)."""
    out = {}
    out["loss_gap"] = max(_rel(p, r, 0.0) for p, r in zip(losses, ref["losses"]))
    g0 = ref["raw_grad"][0]
    med = statistics.median(g0)
    keep = [i for i, g in enumerate(g0) if g >= 1e-3 * med]
    ref_first = ref["first_grad"]
    med_first = statistics.median([ref_first[i] for i in keep])
    out["grad_gap"] = max(_rel(first_grad[i], ref_first[i], med_first) for i in keep)
    moved = [i for i in range(len(change))
             if max(s[i] for s in ref["raw_grad"]) >= 1e-3 * statistics.median(
                 [max(s[j] for s in ref["raw_grad"]) for j in range(len(change))])]
    med_change = statistics.median([ref["change"][i] for i in moved])
    out["change_gap"] = max(_rel(change[i], ref["change"][i], med_change) for i in moved)
    if "outlier_sets" in ref:
        prog = outlier_sets or {}
        diff = 0
        for k in set(prog) | set(ref["outlier_sets"]):
            diff += len(set(prog.get(k, ())) ^ set(ref["outlier_sets"].get(k, ())))
        out["outlier_set_diff"] = float(diff)
    if not limits:        # readings for the limits: every number
        return {k: {"value": v, "limit": None} for k, v in out.items()}
    return {k: {"value": v, "limit": limits[k]} for k, v in out.items() if k in limits}

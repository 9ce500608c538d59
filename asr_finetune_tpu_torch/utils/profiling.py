"""Profiling: the program's own spans and host-sync counter, and a trace for
operators (counterpart of asr_finetune_tpu/utils/profiling.py).

- `span(name)`: a named host range of the program, opened where the work
  happens (the train step's forward, backward and update; a decode
  position and its wait for the card; the evaluator's phases). Off by
  default: `span` then returns one shared object that does nothing, at the
  cost of one flag test.
- `enable()` / `disable()`: while on, each span is recorded as (name,
  thread id, start_ns, end_ns) on `time.perf_counter_ns`, and each host
  sync is counted (`host_syncs`): CUDA is initialised where a card is
  present and PyTorch's sync debug mode set to "warn", and each
  "synchronizing CUDA operation" warning becomes one count under the
  innermost open span of its thread and the program's site, the first
  frame outside torch (file:line of this package; a sync whose caller is
  not this package's code is not the program's and is not counted). A
  thread that never opened a span, as autograd's device thread running a
  backward and remat's recompute, counts under the innermost open span of
  the thread that last opened one, the thread that started the work.
  `disable()` restores the sync debug mode, the warnings filter and the
  warnings hook. `collect()` hands over what was recorded since the last
  collect.
- `trace(logdir)`: a torch.profiler context over the host and, where a
  card is present, its CUDA kernels, with the recorder on and each span
  also a `record_function` range. The Chrome-trace JSON it writes under
  logdir (`<host>_<pid>.<time>.pt.trace.json`, for TensorBoard's PyTorch
  profiler view and ui.perfetto.dev) shows the program's ranges above the
  kernels; `program_counters.json` beside it holds the spans' counts and
  host ms by name, the host syncs by span and site, and under "counters"
  what each source of `add_counters` counted over the block. It takes the
  place of JAX's XLA profile of jax.profiler.start_trace.
- `add_counters(name, read)`: a module's own counters (read() → {counter:
  count}, as evaluation/decode.graph_counters), which trace() reports.
"""
from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import sys
import threading
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

SYNC_TEXT = "called a synchronizing CUDA operation"
NO_SPAN = "(no span)"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_ROOT = os.path.dirname(os.path.dirname(_PKG)) + os.sep
_TORCH = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_SKIP = (os.path.abspath(__file__), os.path.abspath(warnings.__file__))

_on = False
_ranges = False      # also open record_function ranges (inside trace())
_dispatch: List[str] = []   # the open spans of the thread that last opened one
_spans: List[Tuple[str, int, int, int]] = []
_syncs: Dict[str, Dict[str, int]] = {}
_lock = threading.Lock()
_local = threading.local()
_restore: List[Any] = []
_kinds: Dict[str, Optional[str]] = {}   # a frame's file → _file_kind
_sources: Dict[str, Callable[[], Dict[str, int]]] = {}   # add_counters


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _open() -> List[str]:
    """The names of this thread's open spans, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dispatch
        _dispatch = _open()
        _dispatch.append(self.name)
        self.rf = torch.profiler.record_function(self.name) if _ranges else None
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _open().pop()
        _spans.append((self.name, threading.get_ident(), self.t0, t1))
        return False


def span(name: str):
    """A context manager over one named host range of the program."""
    if not _on:
        return _OFF
    return _Span(name)


def _file_kind(filename: str) -> Optional[str]:
    """None for a file the site search passes over (torch's, this module,
    `warnings`), the path from the repository's root for a file of this
    package, "" for any other."""
    kind = _kinds.get(filename, False)
    if kind is False:
        path = os.path.abspath(filename)
        kind = None if path.startswith(_TORCH) or path in _SKIP else \
            path[len(_ROOT):] if path.startswith(_PKG) else ""
        _kinds[filename] = kind
    return kind


def _site() -> str:
    """file:line of the program's frame that caused a sync, the first one
    outside torch, this module and `warnings`; "" when that frame is not
    this package's."""
    f = sys._getframe(1)
    while f is not None:
        kind = _file_kind(f.f_code.co_filename)
        if kind is not None:
            return f"{kind}:{f.f_lineno}" if kind else ""
        f = f.f_back
    return ""


def _count_syncs(show):
    def showwarning(message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith(SYNC_TEXT):
            return show(message, category, filename, lineno, file, line)
        site = _site()
        if site:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _dispatch
            top = stack[-1:]       # one read: the other thread may pop meanwhile
            where = top[0] if top else NO_SPAN
            with _lock:
                by_site = _syncs.setdefault(where, {})
                by_site[site] = by_site.get(site, 0) + 1
    return showwarning


def enable() -> None:
    """Record spans and count host syncs until disable()."""
    global _on
    if _on:
        return
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.init()      # the sync debug mode is set on an initialised CUDA
    mode = torch.cuda.get_sync_debug_mode() if cuda else None
    show = warnings.showwarning
    warnings.filterwarnings("always", message=SYNC_TEXT)
    entry = warnings.filters[0]
    warnings.showwarning = hook = _count_syncs(show)
    if cuda:
        torch.cuda.set_sync_debug_mode("warn")
    _restore[:] = [mode, show, entry, hook]
    _on = True


def disable() -> None:
    """Stop recording; the sync debug mode, the warnings filter and the
    warnings hook are as they were before enable()."""
    global _on, _ranges
    if not _on:
        return
    _on = _ranges = False
    mode, show, entry, hook = _restore
    _restore.clear()
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    if warnings.showwarning is hook:
        warnings.showwarning = show
    with contextlib.suppress(ValueError):
        warnings.filters.remove(entry)
        getattr(warnings, "_filters_mutated", lambda: None)()


def collect() -> Dict[str, Any]:
    """{"spans": [(name, thread id, start_ns, end_ns), ...] in the order they
    closed, "host_syncs": {span: {site: count}}} since the last collect,
    which the call clears."""
    global _spans, _syncs
    with _lock:
        out = {"spans": _spans, "host_syncs": _syncs}
        _spans, _syncs = [], {}
    return out


def _counters(records: Dict[str, Any]) -> Dict[str, Any]:
    """collect()'s records summed: each span name's count and host ms, and
    the host syncs by span and site with their total."""
    by: Dict[str, Dict[str, float]] = {}
    for name, _, t0, t1 in records["spans"]:
        s = by.setdefault(name, {"count": 0, "host_ms": 0.0})
        s["count"] += 1
        s["host_ms"] += (t1 - t0) / 1e6
    syncs = records["host_syncs"]
    return {"spans": by, "host_syncs": syncs,
            "host_syncs_total": sum(n for v in syncs.values() for n in v.values())}


def add_counters(name: str, read: Callable[[], Dict[str, int]]) -> None:
    """Report read()'s counts, as they move over a trace() block, under
    "counters"/name of its program_counters.json."""
    _sources[name] = read


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Profile the block into logdir, the recorder on (its ranges in the
    trace, its counters in logdir/program_counters.json).
    create_perfetto_link: also log the trace file to load into
    ui.perfetto.dev (nothing is uploaded)."""
    global _ranges
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    collect()
    before = {n: read() for n, read in _sources.items()}
    try:
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
            enable()
            _ranges = True     # each span also a record_function range
            try:
                yield
            finally:
                disable()
    finally:
        counters = {n: {k: c - before[n].get(k, 0) for k, c in read().items()}
                    for n, read in _sources.items() if n in before}
        with open(os.path.join(logdir, "program_counters.json"), "w") as f:
            json.dump({**_counters(collect()), "counters": counters}, f, indent=1)
    logger.info("profile trace written to %s (view: tensorboard --logdir %s, PyTorch "
                "Profiler tab)", logdir, logdir)
    if create_perfetto_link:
        newest = max(glob.glob(os.path.join(logdir, "*.pt.trace.json")), key=os.path.getmtime)
        logger.info("open %s in https://ui.perfetto.dev", newest)

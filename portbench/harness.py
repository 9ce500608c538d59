"""What every cell's run shares: set-up phases, host spans, the device trace
of a window, the card's state, the spies that record a kernel call's
shapes, and the per-layer readers found by name.

Spans are the harness's own, around its calls into the port's layers
(time.perf_counter). The device trace is torch.profiler with CUDA activity
only, so the host pays little for it; a marker kernel launched right after
a synchronise ties the trace's clock to the host's.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux /proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class Phases:
    """Set-up time by phase; `import` counts from the process's start."""

    def __init__(self):
        age = process_age_s()
        self.t0 = time.perf_counter() - (age if age is not None else 0.0)
        self.last = self.t0
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        try:
            yield
        finally:
            now = time.perf_counter()
            self.phases[name] = self.phases.get(name, 0.0) + now - self.last
            self.last = now

    def mark(self, name: str) -> None:
        """Close the phase `name` now: the time since the last phase ended."""
        with self(name):
            pass

    def total(self) -> float:
        return self.last - self.t0


class Spans:
    """Host intervals by name, in perf_counter seconds."""

    def __init__(self):
        self.by: Dict[str, List[Tuple[float, float]]] = {}
        self._index = None

    def add(self, name: str, a: float, b: float) -> None:
        self.by.setdefault(name, []).append((a, b))
        self._index = None

    def durations(self, name: str) -> List[float]:
        return [b - a for a, b in self.by.get(name, [])]

    def label_at(self, t: float) -> str:
        """The innermost span holding host time t ("other host work" where
        none does)."""
        if self._index is None:
            ivs = sorted((a, b, n) for n, spans in self.by.items() for a, b in spans)
            self._index = ([a for a, _, _ in ivs], ivs)
        starts, ivs = self._index
        i = bisect.bisect_right(starts, t) - 1
        for a, b, name in reversed(ivs[max(i - 3, 0): i + 1]):
            if a <= t < b:
                return name
        return "other host work"


def p90(values: List[float]) -> Optional[float]:
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=10)[-1]


# ----------------------------------------------------------------- spies

class Calls:
    """Records the logical shapes of the calls of the port's kernels whose
    rooflines the benchmark reports, by wrapping the port's functions that
    see them (installed for a traced window only)."""

    def __init__(self):
        self.calls: List[Tuple] = []
        self._undo: List[Callable[[], None]] = []

    def _wrap(self, module, name: str, record: Callable) -> None:
        orig = getattr(module, name, None)
        if orig is None:
            return

        def spy(*a, **k):
            out = orig(*a, **k)
            record(out, *a, **k)
            return out
        setattr(module, name, spy)
        self._undo.append(lambda: setattr(module, name, orig))

    def install(self) -> None:
        from asr_finetune_tpu_torch.ops import encoder_attention as EA
        from asr_finetune_tpu_torch.ops import w8a8_fused as W8

        def attn(out, q, k, v, hd, s_valid, *others):
            B, Tq, _, H = out
            kind = "attn_bwd" if others else "attn_fwd"
            self.calls.append((kind, B, H, Tq, int(s_valid), int(hd), q.element_size()))

        def w8a8(out, x, w_q8, w_scale, keep=None, addend=None, *rest):
            self.calls.append(("w8a8", x.shape[0], x.shape[1], w_q8.shape[1],
                               x.element_size(), addend is not None))
        self._wrap(EA, "_check", attn)
        self._wrap(W8, "_w8a8_cuda", w8a8)

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def of(self, kind: str) -> List[Tuple]:
        return [c for c in self.calls if c[0] == kind]


# ----------------------------------------------------------- device trace

class Trace:
    """The CUDA activity of a traced window: (name, start_ns, dur_ns) of
    every kernel, copy and set, the window's host length, and the offset
    that maps the trace's clock to perf_counter_ns."""

    def __init__(self):
        self.events: List[Tuple[str, int, int]] = []
        self._kernels: List[Tuple[str, int, int]] = []
        self.window_s = 0.0
        self.offset_ns = 0
        self.host_t0 = 0.0
        self._prof = None

    def start(self, torch) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.host_t0 = time.perf_counter()
        self._marker_host_ns = time.perf_counter_ns()
        torch.ones(1, device="cuda").add_(1)          # the clock marker

    def stop(self, torch) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.host_t0
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        evs = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            evs.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
        evs.sort(key=lambda x: x[1])
        self.events = evs
        self._kernels = [e for e in evs if not e[0].startswith(("Memcpy", "Memset"))]
        if evs:
            self.offset_ns = evs[0][1] - self._marker_host_ns
        self._prof = None

    def kernels(self) -> List[Tuple[str, int, int]]:
        """Kernel launches only (no memcpy or memset)."""
        return self._kernels

    def launches(self) -> int:
        return len(self.kernels())

    def busy_s(self) -> float:
        """Union of every device interval, seconds."""
        total, end = 0, None
        for _, s, d in self.events:
            e = s + d
            if end is None or s >= end:
                total += d
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def device_s(self, keep: Callable[[str], bool]) -> float:
        return sum(d for n, _, d in self.kernels() if keep(n)) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        sums: Dict[str, int] = {}
        for name, _, d in self.kernels():
            sums[name] = sums.get(name, 0) + d
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v / 1e9] for k, v in top]

    def idle_gaps(self, spans: Spans, n: int = 10) -> List[List]:
        """Idle time between device intervals, summed by what the host was
        doing when each gap began, then the longest single gaps."""
        gaps = []
        end = self.events[0][1] if self.events else 0
        for _, s, d in self.events:
            if s > end:
                host = (end - self.offset_ns) / 1e9
                gaps.append((spans.label_at(host), (s - end) / 1e9))
            end = max(end, s + d)
        by: Dict[str, float] = {}
        for label, g in gaps:
            by[label] = by.get(label, 0.0) + g
        out = [[f"all gaps in {k}", v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]
        for label, g in sorted(gaps, key=lambda x: -x[1])[: max(n - len(out), 0)]:
            out.append([f"one gap in {label}", g])
        return out[:n]


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."


# -------------------------------------------------------------- the card

class CardLog:
    """nvidia-smi sampling the card's clocks and power every 500 ms into a
    file, from start() to stop(); nothing where nvidia-smi is absent."""

    QUERY = "timestamp,name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"

    def __init__(self, path: str):
        self.path, self.proc, self._f = path, None, None

    def start(self) -> None:
        exe = shutil.which("nvidia-smi")
        if exe is None:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._f = open(self.path, "w")
        self._f.write(self.QUERY + "\n")
        self._f.flush()
        self.proc = subprocess.Popen([exe, f"--query-gpu={self.QUERY}",
                                      "--format=csv,noheader", "-lms", "500"],
                                     stdout=self._f, stderr=subprocess.DEVNULL)

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.proc = None
        if self._f is not None:
            self._f.close()
            self._f = None


class HostMeter:
    """This process's CPU seconds (all its threads) over a window's wall
    time: under 1 where the dispatching thread waited or was descheduled,
    over 1 where other threads (the data pipeline's) ran beside it."""

    def __init__(self):
        self.out: Dict[str, float] = {}
        self._a = None

    @staticmethod
    def _read():
        import resource
        r = resource.getrusage(resource.RUSAGE_SELF)
        return time.perf_counter(), r.ru_utime + r.ru_stime

    def start(self) -> None:
        self._a = self._read()

    def stop(self) -> None:
        if self._a is None:
            return
        (t0, c0), (t1, c1) = self._a, self._read()
        self.out = {"process_cpu_share": (c1 - c0) / max(t1 - t0, 1e-9),
                    "threads": float(__import__("threading").active_count())}
        self._a = None


def card_info() -> Dict[str, str]:
    """The card's name and power limit by nvidia-smi ({} without it)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {}
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    name, _, limit = out.strip().splitlines()[0].partition(",") if out.strip() else ("", "", "")
    return {"name": name.strip(), "power_limit": limit.strip()}


# ------------------------------------------------------- per-layer readers

def read_metric(name: str, window: Any) -> Optional[float]:
    """portbench/metrics/<name>.py's read(window): a number, or None when
    the window holds nothing for it to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(window)
    return None if value is None else float(value)


def write_json(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)

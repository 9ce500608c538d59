#!/usr/bin/env python3
"""Time and check the port's bf16 fused_mlp on one CUDA card.

    python3 tools/bench_fused_mlp.py [--root TREE] [--rows 4 16] [--kinds ...]
        [--check] [--profile] [--host] [--ptxas] [--trace]

Imports asr_finetune_tpu_torch from TREE (default: this checkout), so two
trees, for example a parent commit unpacked by `git archive` into a
git-ignored directory and this one, can be timed in turns in one process
each on the same card. At whisper-large-v3 width (d 1280, ff 5120, 32
stacked layers, random weights from a seed) it times one fused_mlp call by
CUDA-graph replay, the calls cycling through the 32 layers, for each row
count and each kind of weights: float (bf16), int8 (fc1 and fc2 int8 with
per-channel scales) and mixed (fc1 int8, fc2 bf16). The bound counts each
operand read and each output written once, over 3.35 TB/s (H100 SXM).
--check also holds each call against fused_mlp_plain (max abs error, and
chip_smoke.py's bf16 measures) and two calls against each other (bit
equality), and attributes the difference with an fp64 yardstick: the same
bf16-rounded LN(x) through both products in fp64 (g and the output rounded
to bf16 where the kernel rounds them); it counts the g values the kernel
(its own g, read through the C entry) and the plain version (its fp32
product) round otherwise than the yardstick, and each one's excess over a
rounding step against the yardstick's output; --profile adds the device time per
call of each CUDA kernel (torch.profiler, eager calls); --host the host's
time per call (launches enqueued, not waited for); --trace builds
csrc/decoder_fused.cu with -DMLP_TRACE (its timing probe) into a library of
its own, uses it, and adds each kernel's block phases of one call; --ptxas
prints nvcc's register and shared-memory report of csrc/decoder_fused.cu.
One JSON line per reading.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
D, FF, L = 1280, 5120, 32
KINDS = {"float": (), "int8": ("fc1", "fc2"), "mixed": ("fc1",)}


def device_ms(fn, calls: int = 64, replays: int = 5) -> float:
    """Device time per call: `calls` calls in one CUDA graph, replayed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def host_us(fn, calls: int = 100, repeats: int = 5) -> float:
    """The host's time per call: `calls` calls enqueued back to back (fewer
    launches than the stream's queue holds), the median of `repeats`."""
    import statistics
    import time
    import torch
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def profile(fn, calls: int = 32) -> dict:
    """Device time per call by CUDA kernel name (torch.profiler), eager."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def trace(DF, call) -> dict:
    """Phases of one call's blocks from a build with -DMLP_TRACE: for each
    kernel, its first and last block's start and its last block's end (us,
    globaltimer, from fc1's first start) and the mean cycles over its
    blocks of the wait for the kernel before, the prologue (activations in),
    the products, and the whole block (a split's last block also adds the
    partial sums)."""
    import ctypes
    import numpy as np
    import torch
    for layer in range(4):
        call(layer)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (2 * 1024 * 8))()
    lib = DF._lib()
    lib.mlp_trace.argtypes = [ctypes.c_void_p]
    lib.mlp_trace(ctypes.addressof(buf))
    t = np.frombuffer(buf, dtype=np.uint64).reshape(2, 1024, 8).astype(np.int64)
    t0 = t[0][t[0, :, 0] > 0, 0].min()
    out = {}
    for k, name in enumerate(("fc1", "fc2")):
        b = t[k][t[k, :, 0] > 0]
        c = b[:, 2:]
        out[name] = {"blocks": int(len(b)), "start_us": float((b[:, 0].min() - t0) / 1e3),
                     "last_start_us": float((b[:, 0].max() - t0) / 1e3),
                     "end_us": float((b[:, 1].max() - t0) / 1e3),
                     "cyc_wait": float((c[:, 1] - c[:, 0]).mean()),
                     "cyc_prologue": float((c[:, 2] - c[:, 1]).mean()),
                     "cyc_loop": float((c[:, 3] - c[:, 2]).mean()),
                     "cyc_total": float((c[:, 4] - c[:, 0]).mean())}
    return out


def f64_attribution(DF, x, ln, w, b, li) -> dict:
    """The kernel and the plain version against an fp64 product of the same
    bf16-rounded operands: g flips (bf16 g values that differ from the
    yardstick's) and the excess over one rounding step of each output."""
    import torch
    from asr_finetune_tpu_torch.ops import _build
    (w1, s1), (w2, s2) = w["fc1"], w["fc2"]
    at = lambda t: None if t is None else t[li]   # noqa: E731
    n, ff, bf = x.shape[0], w1.shape[-1], x.dtype
    # the kernel's own g: fused_mlp's C entry with a g buffer of ours
    g_k, out_k = torch.empty((n, ff), dtype=bf, device=x.device), torch.empty_like(x)
    work, counters = DF._workspace(x.device)
    lib = DF._lib()
    err = lib.fused_mlp_fwd(
        1, x.data_ptr(), ln[0][li].data_ptr(), ln[1][li].data_ptr(), w1.data_ptr(),
        b["fc1"][li].data_ptr(), w2.data_ptr(), b["fc2"][li].data_ptr(),
        None if s1 is None else s1[li].data_ptr(), None if s2 is None else s2[li].data_ptr(),
        g_k.data_ptr(), out_k.data_ptr(), work.data_ptr(), DF._MLP_WORK_FLOATS,
        counters.data_ptr(), n, D, ff, li, L, li, L, _build.stream_ptr(x))
    _build.check(lib, err, "fused_mlp")
    h = DF._ln(x, ln[0][li], ln[1][li]).to(bf).float()
    # the kernels' LN(x): the bf16 qkv kernel, whose LN prologue is fc1's
    # code, gives q = LN(x) 64^-0.5 exactly with wq = I and bq = 0
    eye, zero = torch.eye(D, device=x.device, dtype=bf), torch.zeros(D, device=x.device,
                                                                        dtype=bf)
    h_k = DF.fused_qkv(x, ln[0][li], ln[1][li], eye, zero, eye, eye, zero)[0] * 8
    x64 = x.double()
    mean = x64.mean(-1, keepdim=True)
    h_64 = ((x64 - mean) / ((x64 - mean).square().mean(-1, keepdim=True) + 1e-5).sqrt()
            * ln[0][li].double() + ln[1][li].double()).to(bf).float()

    def product(a, wt, s, dt):
        y = a.to(dt) @ wt[li].to(dt)
        return y if s is None else y * s[li].reshape(-1).to(dt)

    def chain64(hh):   # g and the output from hh in fp64, each rounded to bf16
        g = torch.nn.functional.gelu(product(hh, w1, s1, torch.float64)
                                     + b["fc1"][li].double()).to(bf)
        return g, (product(g.float(), w2, s2, torch.float64) + b["fc2"][li].double()
                   + x64).to(bf).float()
    g_p = torch.nn.functional.gelu(product(h, w1, s1, torch.float32)
                                   + b["fc1"][li].float()).to(bf)
    out_p = DF.fused_mlp_plain(x, ln[0][li], ln[1][li], w1[li], b["fc1"][li], w2[li],
                               b["fc2"][li], w1_scale=at(s1), w2_scale=at(s2)).float()

    def excess(o, ref):
        return float(((o - ref).abs() - 2.0 ** -7 * ref.abs()).max())
    row = {"kernel_out_equals_wrapper": bool(torch.equal(out_k, DF.fused_mlp(
        x, *ln, w1, b["fc1"], w2, b["fc2"], w1_scale=s1, w2_scale=s2, layer_idx=li))),
        "h_flips_kernel_vs_plain": int((h_k != h).sum()),
        "h_flips_kernel_vs_f64": int((h_k != h_64).sum()),
        "h_flips_plain_vs_f64": int((h != h_64).sum()),
        "h_flip_rows_kernel_vs_plain": sorted({int(r) for r in (h_k != h).nonzero()[:, 0]})}
    # yardsticks: "same_h" the fp64 products from the plain version's bf16
    # LN(x); "f64" everything in fp64 from x, LN included
    for tag, hh in (("same_h", h), ("f64", h_64)):
        g_64, out_64 = chain64(hh)
        row[f"g_flips_kernel_vs_{tag}"] = int((g_k != g_64).sum())
        row[f"g_flips_plain_vs_{tag}"] = int((g_p != g_64).sum())
        row[f"excess_kernel_vs_{tag}"] = excess(out_k.float(), out_64)
        row[f"excess_plain_vs_{tag}"] = excess(out_p, out_64)
    return row


def load_variant(defines) -> None:
    """Build csrc/decoder_fused.cu with extra -D flags into a library of its
    own and have the wrappers load that one."""
    import ctypes
    import hashlib
    from asr_finetune_tpu_torch.ops import _build
    from asr_finetune_tpu_torch.ops import decoder_fused as DF
    src = _build.CSRC / "decoder_fused.cu"
    h = hashlib.sha256(" ".join(defines).encode() + src.read_bytes())
    for header in sorted(_build.CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    out = pathlib.Path(_build.BUILD_DIR) / f"decoder_fused-variant-{h.hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-o", str(out),
                        str(src)], check=True)
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(out)) if name == "decoder_fused" else load(name)
    DF._LIB = None
    print(json.dumps({"variant": defines}), flush=True)


def ptxas_report(root: pathlib.Path) -> None:
    from asr_finetune_tpu_torch.ops import _build
    out = pathlib.Path(_build.BUILD_DIR) / "ptxas_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                        str(root / "asr_finetune_tpu_torch" / "csrc" / "decoder_fused.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    for line in r.stderr.splitlines():
        if "mlp_fc" in line or ("Used" in line and "registers" in line) or "spill" in line:
            print(line)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 16])
    ap.add_argument("--kinds", nargs="+", default=list(KINDS))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="also the host's time per call (launches only)")
    ap.add_argument("--trace", action="store_true",
                    help="per-block phase times of one call (a build with -DMLP_TRACE)")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("bench_fused_mlp: no CUDA device", file=sys.stderr)
        return 2
    from asr_finetune_tpu_torch.ops import decoder_fused as DF
    from asr_finetune_tpu_torch.ops import quant as Q
    assert pathlib.Path(DF.__file__).resolve().is_relative_to(root), DF.__file__
    if args.ptxas:
        ptxas_report(root)
    if args.trace:
        load_variant(["-DMLP_TRACE"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    ln = (1 + rn(L, D, scale=0.1, dtype=f32), rn(L, D, scale=0.1, dtype=f32))
    w32 = {"fc1": rn(L, D, FF, scale=D ** -0.5, dtype=f32),
           "fc2": rn(L, FF, D, scale=FF ** -0.5, dtype=f32)}
    b = {"fc1": rn(L, FF, scale=0.1), "fc2": rn(L, D, scale=0.1)}
    for kind in args.kinds:
        w = {}
        for k, t in w32.items():
            if k in KINDS[kind]:
                q = Q.quantize_weight(t)
                w[k] = (q[Q.QUANT_KEY], q[Q.SCALE_KEY])
            else:
                w[k] = (t.to(bf16), None)
        for n in args.rows:
            x = rn(n, D)

            def call(layer):
                return DF.fused_mlp(x, *ln, w["fc1"][0], b["fc1"], w["fc2"][0], b["fc2"],
                                    w1_scale=w["fc1"][1], w2_scale=w["fc2"][1],
                                    layer_idx=layer)
            row = {"root": str(root), "kind": kind, "rows": n, "card": card.strip()}
            if args.check:
                li = L - 1
                out = call(li)
                ref = DF.fused_mlp_plain(
                    x, ln[0][li], ln[1][li], w["fc1"][0][li], b["fc1"][li], w["fc2"][0][li],
                    b["fc2"][li], w1_scale=None if w["fc1"][1] is None else w["fc1"][1][li],
                    w2_scale=None if w["fc2"][1] is None else w["fc2"][1][li])
                diff = (out.float() - ref.float()).abs()
                row["max_abs_err"] = float(diff.max())
                # chip_smoke.py's bf16 measures: the excess over one rounding
                # step (2^-7 |ref|) and RMS(err) / RMS(ref)
                row["excess"] = float((diff - 2.0 ** -7 * ref.float().abs()).max())
                row["rms_rel"] = float(diff.square().mean().sqrt()
                                       / ref.float().square().mean().sqrt())
                row["bit_equal"] = bool(torch.equal(out, call(li)))
                row["finite"] = bool(out.isfinite().all())
                row.update(f64_attribution(DF, x, ln, w, b, li))
            it = iter(range(10 ** 9))
            row["ms"] = device_ms(lambda: call(next(it) % L))
            if args.host:
                row["host_us"] = host_us(lambda: call(next(it) % L))
            moved = sum(t[0].numel() // L * t[0].element_size()
                        + (0 if t[1] is None else t[1].numel() // L * 4) for t in w.values())
            moved += 2 * x.numel() * 2 + 2 * D * 4 + (FF + D) * 2
            row["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
            if args.trace:
                row["trace"] = trace(DF, call)
            if args.profile:
                row["by_kernel_us"] = profile(lambda: call(next(it) % L))
            print(json.dumps(row), flush=True)
        del w
    return 0


if __name__ == "__main__":
    sys.exit(main())

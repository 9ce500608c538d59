#!/usr/bin/env python3
"""Time and check the port's bf16 fused_attn on one CUDA card.

    python3 tools/bench_fused_attn.py [--root TREE] [--variants ...] [--check]
        [--profile] [--sdpa] [--host] [--trace] [--ptxas]

Imports asr_finetune_tpu_torch from TREE (default: this checkout), so two
trees, for example a parent commit unpacked by `git archive` into a
git-ignored directory and this one, can be timed in turns in one process
each on the same card. At whisper-large-v3 width (d 1280, 20 heads, 32
stacked layers, random weights from a seed, batch 4) it times one fused_attn
or fused_attn_beam call by CUDA-graph replay, the calls cycling through the
32 layers, for each variant of VARIANTS: cross-attention over the padded
source (S 1536, s_valid 1500) with G = 1 (4 rows) or kv_group 4 (16 rows,
beam-4), bf16 or int8 K/V, self-attention over the decode cache (128, pos
63), and beam self-attention over a (32, rows, 128, 1280) cache through a
seeded ancestry map at pos 63 (4 x 4 rows, or 2 x 10), each with float
weights, and cross, self and beam-4 also with an int8 wo (a merged-LoRA
base). The bound counts each operand read and each output written once
(beam: each distinct live cache row at each position once, as chip_smoke.py's
beam_calls), over 3.35 TB/s (H100 SXM). --check also holds each call
against fused_attn_plain or fused_attn_beam_plain
(max abs error, and chip_smoke.py's bf16 measures) and two calls against
each other (bit equality), beam variants also both against an fp64
yardstick (beam_f64: output flips and excess of kernel and plain); --profile adds the device time per call of each
CUDA kernel (torch.profiler, eager calls) and the launches a call; --host
the host's time per call (launches enqueued, not waited for);
--sdpa times the attention alone on the same K/V with
torch.nn.functional.scaled_dot_product_attention (bf16; for int8 K/V the
float K/V they were quantized from), a yardstick the port never calls;
--trace builds csrc/decoder_fused.cu with -DATTN_TRACE (the kernels'
timing probe) into a library of its own, uses it, and adds each kernel's
block phases of one call; --ptxas prints nvcc's register and
shared-memory report of the fused_attn kernels. One JSON line per
reading.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
D, H, L, B = 1280, 20, 32, 4
S_PAD, S_VALID = 1536, 1500
SELF_T, SELF_POS = 128, 63
# name: (mode, kv_group or beams, int8 K/V, int8 wo, utterances)
VARIANTS = {
    "cross_g4": ("cross", 4, False, False, B),
    "cross": ("cross", 1, False, False, B),
    "cross_kv8_g4": ("cross", 4, True, False, B),
    "cross_kv8": ("cross", 1, True, False, B),
    "self": ("self", 1, False, False, B),
    "cross_wo8": ("cross", 1, False, True, B),
    "self_wo8": ("self", 1, False, True, B),
    "beam": ("beam", 4, False, False, B),
    "beam_wo8": ("beam", 4, False, True, B),
    "beam_w10": ("beam", 10, False, False, 2),
}


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


def replay_stamps(DF, call):
    """The probe's (3, 4096, 4) globaltimer stamps of one call(L - 1) in a
    build with -DATTN_TRACE, the call replayed from a CUDA graph as the
    timing does (eager launches would show the host's gaps)."""
    import numpy as np
    import torch
    lib = DF._lib()
    lib.attn_trace.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * (3 * 4096 * 4))()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for layer in range(3):
            call(layer)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call(L - 1)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    lib.attn_trace(ctypes.addressof(buf))   # read and zeroed
    graph.replay()
    torch.cuda.synchronize()
    lib.attn_trace(ctypes.addressof(buf))
    return np.frombuffer(buf, dtype=np.uint64).reshape(3, 4096, 4).astype(np.int64)


def trace(DF, call) -> dict:
    """Phases of one call's blocks (replay_stamps): for each kernel, its
    blocks, its first and last block's start and its last block's end (us,
    globaltimer, from the call's first start), and over its blocks the
    median and largest time from entry to the end of griddepcontrol.wait,
    to its operands in shared memory, and to exit."""
    import numpy as np
    t = replay_stamps(DF, call)
    live = [t[k][t[k, :, 0] > 0] for k in range(3)]
    t0 = min(int(b[:, 0].min()) for b in live if len(b))
    out = {}
    for name, b in zip(("attn_q", "attn_chunk", "attn_wo"), live):
        if not len(b):
            continue
        span = lambda j: (b[:, j] - b[:, 0]) / 1e3   # noqa: E731
        out[name] = {"blocks": int(len(b)), "start_us": float((b[:, 0].min() - t0) / 1e3),
                     "last_start_us": float((b[:, 0].max() - t0) / 1e3),
                     "end_us": float((b[:, 3].max() - t0) / 1e3),
                     "wait_us": [float(np.median(span(1))), float(span(1).max())],
                     "ready_us": [float(np.median(span(2))), float(span(2).max())],
                     "block_us": [float(np.median(span(3))), float(span(3).max())]}
    return out


def load_variant(defines) -> None:
    """Build csrc/decoder_fused.cu with extra -D flags into a library of its
    own and have the wrappers load that one."""
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
    out = pathlib.Path(_build.BUILD_DIR) / "ptxas_probe_attn.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                        str(root / "asr_finetune_tpu_torch" / "csrc" / "decoder_fused.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    keep = False
    for line in r.stderr.splitlines():
        if "Compiling entry function" in line:
            keep = "attn_" in line
        if keep:
            print(line)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def beam_f64(x, k, v, wo, bo, q, pos, anc, so):
    """fused_attn_beam of one layer's operands with every sum in fp64,
    rounding to bf16 what the kernel and the plain version both round (q,
    p for p.v, o, the output): the yardstick --check holds both against."""
    import torch
    nb, beams, _ = anc.shape
    n, (rows_n, d) = pos + 1, x.shape
    rows = (torch.arange(nb, device=x.device)[:, None, None] * beams
            + anc[:, :, :n].long()).reshape(rows_n, n)
    cols = torch.arange(n, device=x.device)[None, :]
    kh, vh = (t[rows, cols].double().view(rows_n, n, H, 64) for t in (k, v))
    qh = q.to(torch.bfloat16).double().view(rows_n, H, 64)
    s = torch.einsum("rhd,rthd->rht", qh, kh)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pv = torch.einsum("rht,rthd->rhd", e.to(torch.bfloat16).double(), vh)
    o = (pv / e.sum(-1, keepdim=True)).reshape(rows_n, d).to(torch.bfloat16).double()
    y = o @ wo.double()
    if so is not None:
        y = y * so.reshape(-1).double()
    return (y + bo.double() + x.double()).to(torch.bfloat16).float()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sdpa", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="also the host's time per call (launches only)")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="per-block phase times of one call (a build with -DATTN_TRACE)")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("bench_fused_attn: no CUDA device", file=sys.stderr)
        return 2
    from asr_finetune_tpu_torch.evaluation import decode as decode_lib
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.ops import decoder_fused as DF
    from asr_finetune_tpu_torch.ops import quant as Q
    assert pathlib.Path(DF.__file__).resolve().is_relative_to(root), DF.__file__
    if args.ptxas:
        ptxas_report(root)
    if args.trace:
        load_variant(["-DATTN_TRACE"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    ln = (1 + rn(L, D, scale=0.1, dtype=f32), rn(L, D, scale=0.1, dtype=f32))
    w32 = {k: rn(L, D, D, scale=D ** -0.5, dtype=f32) for k in "qo"}
    wq, bq, bo = w32["q"].to(bf16), rn(L, D, scale=0.1), rn(L, D, scale=0.1)
    wo = {False: (w32["o"].to(bf16), None)}
    qo = Q.quantize_weight(w32["o"])
    wo[True] = (qo[Q.QUANT_KEY], qo[Q.SCALE_KEY])
    cross = (rn(L, B, S_PAD, D), rn(L, B, S_PAD, D))
    # int8 cross K/V as the decode loop holds them (whisper.quantize_cross_kv,
    # laid out by decode._prepare_fused): (k_q8, v_q8, k_scale_d, v_scale_d)
    heads = {n: t.view(L, B, S_PAD, H, 64) for n, t in zip("kv", cross)}
    q8, _, _ = decode_lib._prepare_fused(cross[0][0], W.quantize_cross_kv(heads), SELF_T, bf16)
    cross8 = (q8["k_q8"], q8["v_q8"], q8["k_scale_d"], q8["v_scale_d"])
    self_kv = (rn(L, B, SELF_T, D), rn(L, B, SELF_T, D))
    li = L - 1
    for name in args.variants:
        mode, G, kv8, wo8, utts = VARIANTS[name]
        n = utts * G
        x = rn(n, D)
        wo_, so = wo[wo8]
        extra = 0   # bytes beyond the operands': the beam's live cache rows
        if mode == "beam":
            kb, vb = rn(L, n, SELF_T, D), rn(L, n, SELF_T, D)
            anc = torch.randint(0, G, (utts, G, SELF_T), generator=g, device=dev,
                                dtype=torch.int32)
            q, nv = rn(n, D, scale=0.125, dtype=f32), SELF_POS + 1

            def call(layer):
                return DF.fused_attn_beam(x, kb, vb, wo_, bo, q=q, pos=SELF_POS, ancestry=anc,
                                          wo_scale=so, layer_idx=layer)

            def plain():
                return DF.fused_attn_beam_plain(x, kb[li], vb[li], wo_[li], bo[li], q, SELF_POS,
                                                anc, None if so is None else so[li])
            live = sum(len(set(anc[u, :, t].tolist())) for u in range(utts) for t in range(nv))
            reads = (x, q, anc[:, :, :nv], wo_[li], None if so is None else so[li], bo[li])
            extra = 2 * live * D * kb.element_size()
        elif mode == "self":
            k, v, ks, vs, nv = *self_kv, None, None, SELF_POS + 1
            q = rn(n, D, scale=0.125, dtype=f32)

            def call(layer):
                return DF.fused_attn(x, k, v, wo_, bo, q=q, pos=SELF_POS, wo_scale=so,
                                     layer_idx=layer)

            def plain():
                return DF.fused_attn_plain(x, k[li], v[li], wo_[li], bo[li], q=q, n_valid=nv,
                                           wo_scale=None if so is None else so[li])
            reads = (x, q, k[li][:, :nv], v[li][:, :nv], wo_[li],
                     None if so is None else so[li], bo[li])
        else:
            k, v, ks, vs = cross8 if kv8 else (*cross, None, None)
            nv = S_VALID

            def call(layer):
                return DF.fused_attn(x, k, v, wo_, bo, s_valid=S_VALID, ln_scale=ln[0],
                                     ln_bias=ln[1], wq=wq, bq=bq, k_scale=ks, v_scale=vs,
                                     wo_scale=so, layer_idx=layer, kv_group=G)

            def plain():
                return DF.fused_attn_plain(
                    x, k[li], v[li], wo_[li], bo[li], n_valid=S_VALID, ln_scale=ln[0][li],
                    ln_bias=ln[1][li], wq=wq[li], bq=bq[li],
                    wo_scale=None if so is None else so[li],
                    k_scale=None if ks is None else ks[li],
                    v_scale=None if vs is None else vs[li], kv_group=G)
            reads = (x, ln[0][li], ln[1][li], wq[li], bq[li], k[li][:, :nv], v[li][:, :nv],
                     None if ks is None else ks[li], None if vs is None else vs[li],
                     wo_[li], None if so is None else so[li], bo[li])
        row = {"root": str(root), "variant": name, "rows": n, "card": card.strip()}
        if args.check:
            out = call(li)
            ref = plain()
            diff = (out.float() - ref.float()).abs()
            row["max_abs_err"] = float(diff.max())
            # chip_smoke.py's bf16 measures: the excess over one rounding
            # step (2^-7 |ref|) and RMS(err) / RMS(ref)
            row["excess"] = float((diff - 2.0 ** -7 * ref.float().abs()).max())
            row["rms_rel"] = float(diff.square().mean().sqrt()
                                   / ref.float().square().mean().sqrt())
            row["bit_equal"] = bool(torch.equal(out, call(li)))
            row["finite"] = bool(out.isfinite().all())
            if mode == "beam":   # both against the fp64 yardstick: whose rounding moved
                y64 = beam_f64(x, kb[li], vb[li], wo_[li], bo[li], q, SELF_POS, anc,
                               None if so is None else so[li])
                for tag, o_ in (("kernel", out.float()), ("plain", ref.float())):
                    row[f"flips_{tag}_vs_f64"] = int((o_ != y64).sum())
                    row[f"excess_{tag}_vs_f64"] = float(
                        ((o_ - y64).abs() - 2.0 ** -7 * y64.abs()).max())
        it = iter(range(10 ** 9))
        row["ms"] = device_ms(lambda: call(next(it) % L))
        row["bound_ms"] = (nbytes(*reads) + nbytes(x) + extra) / HBM_BYTES_PER_S * 1e3
        if args.host:
            row["host_us"] = host_us(lambda: call(next(it) % L))
        if args.trace:
            row["trace"] = trace(DF, call)
        if args.profile:
            DF.reset_kernel_launches()
            call(li)
            torch.cuda.synchronize()
            row["launches"] = {k_: c for k_, c in DF.kernel_launches().items() if c}
            row["by_kernel_us"] = profile(lambda: call(next(it) % L))
        if args.sdpa and mode != "beam":   # no library call gathers through an ancestry
            fk, fv = (cross if mode == "cross" else self_kv)
            Bk = fk.shape[1]
            qh = rn(Bk, H, G, 64)

            def sdpa(layer):
                kh = fk[layer].view(Bk, -1, H, 64).transpose(1, 2)[:, :, :nv]
                vh = fv[layer].view(Bk, -1, H, 64).transpose(1, 2)[:, :, :nv]
                return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
            row["sdpa_ms"] = device_ms(lambda: sdpa(next(it) % L))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

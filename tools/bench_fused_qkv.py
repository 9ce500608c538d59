#!/usr/bin/env python3
"""Time and check the port's bf16 fused_qkv on one CUDA card.

    python3 tools/bench_fused_qkv.py [--root TREE] [--rows 4 16] [--kinds ...]
        [--check] [--profile] [--host] [--ptxas] [--trace] [--define=-DNAME=V,...]

Imports asr_finetune_tpu_torch from TREE (default: this checkout), so two
trees, for example a parent commit unpacked by `git archive` into a
git-ignored directory and this one, can be timed in turns in one process
each on the same card. At whisper-large-v3 width (d 1280, 32 stacked layers,
random weights from a seed) it times one fused_qkv call by CUDA-graph
replay, the calls cycling through the 32 layers, for each row count and
each kind of weights: float (bf16), int8 (q, k and v int8 with per-channel
scales) and mixed (k int8 beside bf16 q and v, a merged-LoRA base). "ms" is
the call alone; "ms_step" the decode step's form: k and v into row 63 of a
(32, rows, 128, d) self cache, through the call's cache operands where the
tree has them, else the call and the two index copies the step made. The
bound counts each operand read and each output written once, over 3.35
TB/s (H100 SXM). --check also holds each call against fused_qkv_plain (max
abs error, and chip_smoke.py's bf16 measures, over q, k and v) and two calls
against each other (bit equality); --profile adds the device time per call
of each CUDA kernel (torch.profiler, eager calls) and the launches a call;
--host the host's time per call (launches enqueued, not waited for);
--ptxas prints nvcc's register and shared-memory report of qkv_kernel;
--trace builds csrc/decoder_fused.cu with -DATTN_TRACE (the product
kernels' timing probe) into a library of its own, uses it, and adds the
blocks' phases of one call replayed from a graph (entry to the end of
griddepcontrol.wait, to x in shared memory, to LN(x) done, to the
products done, to the split sums added, to exit); --define builds such a
library with other -D flags (comma-separated: a variant of the source) and
times that. One JSON line per reading.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import subprocess
import sys

from bench_fused_attn import load_variant, replay_stamps
from bench_fused_mlp import device_ms, host_us, profile

HBM_BYTES_PER_S = 3.35e12
D, L = 1280, 32
SELF_T, SELF_POS = 128, 63
KINDS = {"float": "", "int8": "qkv", "mixed": "k"}


def ptxas_report(root: pathlib.Path) -> None:
    from asr_finetune_tpu_torch.ops import _build
    out = pathlib.Path(_build.BUILD_DIR) / "ptxas_probe_qkv.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                        str(root / "asr_finetune_tpu_torch" / "csrc" / "decoder_fused.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    keep = False
    for line in r.stderr.splitlines():
        if "Compiling entry function" in line:
            keep = "qkv_kernel" in line
        if keep:
            print(line)


def trace(DF, call) -> dict:
    """Phases of one call's blocks (bench_fused_attn.replay_stamps; qkv's
    inner stamps sit in the core's slots): the blocks, the last block's end
    (us, globaltimer, from the call's first block start), and the median
    and largest time from entry to the end of griddepcontrol.wait, to x in
    shared memory, to LN(x) done, to the products done, to the split sums
    added (the tiles' last blocks) and to exit."""
    import numpy as np
    t = replay_stamps(DF, call)
    live = t[0, :, 0] > 0
    entry = t[0, live, 0]
    stamps = {"wait": t[0, live, 1], "x_in": t[1, live, 0], "ln_done": t[1, live, 1],
              "products": t[1, live, 2], "sums_added": t[1, live, 3], "exit": t[0, live, 3]}
    out = {"blocks": int(live.sum()), "end_us": float((t[0, live, 3].max() - entry.min()) / 1e3)}
    for name, st in stamps.items():
        ok = st > 0
        span = (st[ok] - entry[ok]) / 1e3
        out[name + "_us"] = [float(np.median(span)), float(span.max())] if ok.any() else None
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 16])
    ap.add_argument("--kinds", nargs="+", default=list(KINDS), choices=list(KINDS))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="also the host's time per call (launches only)")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="per-block phase times of one call (a build with -DATTN_TRACE)")
    ap.add_argument("--define", default="",
                    help="comma-separated -D flags of a variant build of "
                         "csrc/decoder_fused.cu")
    args = ap.parse_args()
    args.define = [f for f in args.define.split(",") if f]
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("bench_fused_qkv: no CUDA device", file=sys.stderr)
        return 2
    from asr_finetune_tpu_torch.ops import decoder_fused as DF
    from asr_finetune_tpu_torch.ops import quant as Q
    assert pathlib.Path(DF.__file__).resolve().is_relative_to(root), DF.__file__
    if args.ptxas:
        ptxas_report(root)
    if args.trace or args.define:
        load_variant(args.define + (["-DATTN_TRACE"] if args.trace else []))
    cache_form = "cache_k" in inspect.signature(DF.fused_qkv).parameters
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    ln = (1 + rn(L, D, scale=0.1, dtype=f32), rn(L, D, scale=0.1, dtype=f32))
    w32 = {k: rn(L, D, D, scale=D ** -0.5, dtype=f32) for k in "qkv"}
    b = {k: rn(L, D, scale=0.1) for k in "qv"}
    li = L - 1
    for kind in args.kinds:
        w = {}
        for k, t in w32.items():
            if k in KINDS[kind]:
                q = Q.quantize_weight(t)
                w[k] = (q[Q.QUANT_KEY], q[Q.SCALE_KEY])
            else:
                w[k] = (t.to(bf16), None)
        scales = {f"w{k}_scale": w[k][1] for k in "qkv"}
        for n in args.rows:
            x = rn(n, D)
            cache = (rn(L, n, SELF_T, D), rn(L, n, SELF_T, D))

            def call(layer):
                return DF.fused_qkv(x, *ln, w["q"][0], b["q"], w["k"][0], w["v"][0], b["v"],
                                    layer_idx=layer, **scales)

            def step_form(layer):
                if cache_form:
                    return DF.fused_qkv(x, *ln, w["q"][0], b["q"], w["k"][0], w["v"][0],
                                        b["v"], layer_idx=layer, cache_k=cache[0],
                                        cache_v=cache[1], pos=SELF_POS, **scales)
                q, k, v = call(layer)
                cache[0][layer, :, SELF_POS] = k
                cache[1][layer, :, SELF_POS] = v
                return q, k, v
            row = {"root": str(root), "kind": kind, "rows": n, "card": card.strip(),
                   "cache_form": cache_form, "define": args.define}
            if args.check:
                out = call(li)
                ref = DF.fused_qkv_plain(
                    x, ln[0][li], ln[1][li], w["q"][0][li], b["q"][li], w["k"][0][li],
                    w["v"][0][li], b["v"][li],
                    **{k: None if s is None else s[li] for k, s in scales.items()})
                err = excess = rms = 0.0
                for o, r in zip(out, ref):
                    diff = (o.float() - r.float()).abs()
                    err = max(err, float(diff.max()))
                    # chip_smoke.py's bf16 measures: the excess over one
                    # rounding step (2^-7 |ref|) and RMS(err) / RMS(ref)
                    excess = max(excess, float((diff - 2.0 ** -7 * r.float().abs()).max()))
                    rms = max(rms, float(diff.square().mean().sqrt()
                                         / r.float().square().mean().sqrt()))
                row.update(max_abs_err=err, excess=excess, rms_rel=rms,
                           bit_equal=all(torch.equal(a, c) for a, c in zip(out, call(li))),
                           finite=all(bool(o.isfinite().all()) for o in out))
                sq, sk, sv = step_form(li)
                row["step_form_equal"] = bool(
                    torch.equal(sq, out[0]) and torch.equal(cache[0][li, :, SELF_POS], out[1])
                    and torch.equal(cache[1][li, :, SELF_POS], out[2]))
            it = iter(range(10 ** 9))
            row["ms"] = device_ms(lambda: call(next(it) % L))
            row["ms_step"] = device_ms(lambda: step_form(next(it) % L))
            if args.host:
                row["host_us"] = host_us(lambda: step_form(next(it) % L))
            moved = sum(t[0].numel() // L * t[0].element_size()
                        + (0 if t[1] is None else t[1].numel() // L * 4) for t in w.values())
            moved += x.numel() * 2 + 2 * D * 4 + 2 * D * 2 + n * D * (4 + 2 + 2)
            row["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
            if args.trace:
                row["trace"] = trace(DF, step_form)
            if args.profile:
                DF.reset_kernel_launches()
                step_form(li)
                torch.cuda.synchronize()
                row["launches"] = {k_: c for k_, c in DF.kernel_launches().items() if c}
                row["by_kernel_us"] = profile(lambda: step_form(next(it) % L))
            print(json.dumps(row), flush=True)
            del cache
        del w
    return 0


if __name__ == "__main__":
    sys.exit(main())

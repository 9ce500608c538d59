#!/usr/bin/env python3
"""Time and check the port's W8A8 kernel on one CUDA card.

    python3 tools/bench_w8a8.py [--root TREE] [--check] [--profile]

Imports asr_finetune_tpu_torch from TREE (default: this checkout), so two
trees, for example a parent commit unpacked by `git archive` into a
git-ignored directory and this one, can be timed in turns in one process
each on the same card. In bf16, at Whisper large-v3's PEFT shapes (batch
4: encoder rows 6000, decoder rows 768, chip_smoke.py's W8A8_SHAPES) and
at Uni-MoE-2.0-Omni's expert shapes (rows 1536 ≈ one expert's share of a
batch of 8: gate/up 3584 → 18944, down 18944 → 3584, the fixed experts'
2368 and the projector's 1280 → 3584), it times by CUDA-graph replay "ms",
the kernel (quantize pass and GEMM) reading the weight's K-major copy;
"plain_ms", w8a8_plain; "int_mm_ms", torch._int_mm on the same int8
operands; "bf16_ms", torch.matmul with the dequantized weight (the
library yardsticks, which the port never calls for this product); "bound_ms",
max(bytes / 3.35 TB/s, 2 m K N / 1,979 TOP/s). A shape the tree refuses
(K past 8192 before the two-pass quantize kernel) is reported as refused.
--check holds the kernel to w8a8_plain bit for bit, pure and with the
outlier keep-mask and addend of the dynamic top-8 form, and through the
view w_q8 = w_nk.t() (a base held only K-major); --profile adds each CUDA
kernel's device µs a call by name (torch.profiler). One JSON line a shape.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

from bench_fused_mlp import device_ms, profile

HBM_BYTES_PER_S, INT8_OPS = 3.35e12, 1979e12
SHAPES = (("whisper encoder q/k/v/o", 6000, 1280, 1280), ("whisper encoder fc1", 6000, 1280, 5120),
          ("whisper encoder fc2", 6000, 5120, 1280), ("whisper decoder q/k/v/o", 768, 1280, 1280),
          ("whisper decoder fc1", 768, 1280, 5120), ("whisper decoder fc2", 768, 5120, 1280),
          ("whisper encoder q|k|v fused", 6000, 1280, 3840),
          ("unimoe dynamic gate/up", 1536, 3584, 18944),
          ("unimoe dynamic down", 1536, 18944, 3584),
          ("unimoe fixed gate/up", 3936, 3584, 2368), ("unimoe fixed down", 3936, 2368, 3584),
          ("unimoe projector", 2400, 1280, 3584))


def card() -> dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return {"card": out}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    p.add_argument("--check", action="store_true")
    p.add_argument("--profile", action="store_true")
    a = p.parse_args()
    root = pathlib.Path(a.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from asr_finetune_tpu_torch.ops import _build
    from asr_finetune_tpu_torch.ops import quant as Q
    from asr_finetune_tpu_torch.ops import w8a8_fused as WF
    _build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    print(json.dumps({"root": str(root), **card()}), flush=True)
    for name, m, K, N in SHAPES:
        q = Q.quantize_weight(torch.randn((K, N), generator=g, device=dev) * K ** -0.5)
        w8, ws = q["w_q8"], q["w_scale"]
        w_nk = w8.t().contiguous()
        x = torch.randn((m, K), generator=g, device=dev)
        x[:, 5::K // 6] *= 12.0                 # emergent outlier features
        x = x.to(torch.bfloat16)
        row = {"shape": name, "m": m, "K": K, "N": N}
        try:
            WF.w8a8(x, w8, ws, None, None, w_nk)
        except ValueError as e:
            row["refused"] = str(e)
            print(json.dumps(row), flush=True)
            continue
        nbytes = 2 * m * K + K * N + 4 * N + 2 * m * N
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, 2.0 * m * K * N / INT8_OPS) * 1e3
        row["ms"] = device_ms(lambda: WF.w8a8(x, w8, ws, None, None, w_nk), 16)
        row["plain_ms"] = device_ms(lambda: WF.w8a8_plain(x, w8, ws), 2)
        x32 = x.float()
        xs = torch.clamp(x32.abs().amax(-1, keepdim=True), min=1e-8) * WF.INV_127
        x8 = torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8)
        w8_cm = w8.t().contiguous().t()
        w_deq = Q.dequantize_weight(q, torch.bfloat16)
        row["int_mm_ms"] = device_ms(lambda: torch._int_mm(x8, w8_cm), 16)
        row["bf16_ms"] = device_ms(lambda: torch.matmul(x, w_deq), 16)
        row["roofline_pct"] = 100.0 * row["bound_ms"] / row["ms"]
        if a.check:
            out = WF.w8a8(x, w8, ws, None, None, w_nk)
            pure = torch.equal(out, WF.w8a8_plain(x, w8, ws))
            keep, addend = Q._outlier_split(x, w8, ws, Q.QuantConfig(matmul=True,
                                                                     outlier_cols=8))
            outl = torch.equal(WF.w8a8(x, w8, ws, keep, addend, w_nk),
                               WF.w8a8_plain(x, w8, ws, keep, addend))
            view = torch.equal(WF.w8a8(x, w_nk.t(), ws, None, None, w_nk), out)
            row["bit_equal"] = {"pure": pure, "outliers": outl, "kmajor_view": view}
        if a.profile:
            row["kernels_us"] = profile(lambda: WF.w8a8(x, w8, ws, None, None, w_nk))
        print(json.dumps(row), flush=True)
        del w_deq, x8, w8_cm
        torch.cuda.empty_cache()
    print(json.dumps(card()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

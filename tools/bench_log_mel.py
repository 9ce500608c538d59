#!/usr/bin/env python3
"""Time and check the port's log-mel kernel on one CUDA card.

    python3 tools/bench_log_mel.py [--root TREE] [--batch 4] [--mels 128 80]
        [--check] [--profile] [--ptxas] [--trace]

Imports asr_finetune_tpu_torch from TREE (default: this checkout), so two
trees, for example a parent commit unpacked by `git archive` into a
git-ignored directory and this one, can be timed in turns in one process
each on the same card. Over B utterances of 30 s of seeded noise (the last
one part silence) it times, by CUDA-graph replay: "ms", `log_mel_fused`
(the whole function); "raw_ms", the kernel's log10 mel power alone (no
floor); "plain_ms", `log_mel_fused_plain`; "conv_ms", the production conv
form ops/logmel.log_mel_spectrogram; "stft_ms", `stft_log_mel` (torch.stft
on cuFFT, then power, the mel product, log10 and the floor; the port never
calls it). A tree whose production form uploads its tables at every call
(a pageable copy, which no CUDA graph can capture) has its plain and conv
readings from torch.profiler's sum over their kernels and copies
("timed_by"). The bound counts the audio read once and the output written
once over 3.35 TB/s and, where the tree counts them (`flops_per_frame`),
its operations over 67 TFLOP/s (H100 SXM). --check also holds the function
against its plain version (max abs error, RMS(err) / RMS(ref)), two calls
against each other (bit equality), and reads on a tonal input (a few
sinusoids, a quiet tail) the largest error of the kernel and of the plain
version against `log_mel_f64`, the function in float64 on the card;
--profile adds the device µs per call of each CUDA kernel and copy of the
function and of the conv form (torch.profiler, eager calls); --ptxas
prints nvcc's register, shared-memory and spill report of csrc/logmel.cu;
--trace builds csrc/logmel.cu with -DLOGMEL_TRACE (the kernel's timing
probe) into a library of its own, uses it, and adds the phases of one
eager call's blocks (the first 4 utterances): the span from the first
block's entry to the last one's exit, and the median and largest cycles of
each block's phases: the table's staging and the wait for the kernel
before, pass 1 and the samples' arrival, passes 2 and 3, split, band sums.
One JSON line per reading.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

from bench_fused_mlp import device_ms, profile

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def log_mel_f64(audio, n_mels: int):
    """The function in float64 on audio's device: reflect padding of 200,
    the fp64 periodic hann window, torch.fft.rfft of each 400-sample frame
    at hop 160, power, the slaney bank, log10(max(·, 1e-10)), the floor at
    each utterance's max − 8, (x + 4) / 4."""
    import math
    import torch
    from asr_finetune_tpu_torch.ops.logmel import mel_filter_bank
    x = torch.nn.functional.pad(audio.double()[:, None], (200, 200), mode="reflect")[:, 0]
    frames = x.unfold(-1, 400, 160)[:, :3000]
    n = torch.arange(400, dtype=torch.float64, device=audio.device)
    spec = torch.fft.rfft(frames * (0.5 - 0.5 * torch.cos(2 * math.pi * n / 400)), dim=-1)
    fb = torch.from_numpy(mel_filter_bank(n_mels=n_mels)).double().to(audio.device)
    log = torch.log10(torch.clamp((spec.real.square() + spec.imag.square()) @ fb, min=1e-10))
    m = log.amax(dim=(1, 2), keepdim=True)
    return (torch.maximum(log, m - 8.0) + 4.0) / 4.0


def stft_log_mel(audio, window, melfb):
    """The function through torch.stft (cuFFT): center=True with reflect
    padding, the hann window, power, the mel product, log10 and Whisper's
    floor, (B, 3000, n_mels). A yardstick the port never calls."""
    import torch
    spec = torch.stft(audio, 400, 160, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[..., :3000]
    power = spec.real.square() + spec.imag.square()
    log = torch.log10(torch.clamp(torch.matmul(power.transpose(1, 2), melfb), min=1e-10))
    m = log.amax(dim=(1, 2), keepdim=True)
    return (torch.maximum(log, m - 8.0) + 4.0) / 4.0


def tonal_audio(B: int, device):
    """B utterances of three seeded sinusoids each (amplitudes 0.5 to 0.005)
    over 20 s, then 10 s at 1e-4 of seeded noise."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    t = np.arange(480000) / 16000.0
    out = np.zeros((B, 480000))
    for b in range(B):
        for amp in (0.5, 0.05, 0.005):
            out[b] += amp * np.sin(2 * np.pi * rng.uniform(60, 7900) * t + rng.uniform(0, 6.3))
        out[b, 320000:] = 1e-4 * rng.standard_normal(160000)
    return torch.from_numpy(out.astype(np.float32)).to(device)


def ptxas_report(root: pathlib.Path) -> None:
    from asr_finetune_tpu_torch.ops import _build
    out = pathlib.Path(_build.BUILD_DIR) / "ptxas_probe_logmel.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-o", str(out), str(root / "asr_finetune_tpu_torch" / "csrc" / "logmel.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    print("\n".join(line for line in r.stderr.splitlines() if line.strip()))


def load_trace_build(LF) -> None:
    """Build csrc/logmel.cu with -DLOGMEL_TRACE into a library of its own
    and have the wrapper load that one."""
    from asr_finetune_tpu_torch.ops import _build
    src = _build.CSRC / "logmel.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_build.CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    out = pathlib.Path(_build.BUILD_DIR) / f"logmel-trace-{h.hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DLOGMEL_TRACE", "-o",
                        str(out), str(src)], check=True)
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(out)) if name == "logmel" else load(name)
    LF._LIB = None


def trace(LF, call) -> dict:
    """Phases of one eager call's blocks from a -DLOGMEL_TRACE build."""
    import numpy as np
    import torch
    call()
    torch.cuda.synchronize()
    lib = LF._lib()
    n = lib.log_mel_trace_blocks()
    buf = (ctypes.c_ulonglong * (n * 8))()
    lib.log_mel_trace.argtypes = [ctypes.c_void_p]
    if lib.log_mel_trace(ctypes.addressof(buf)) != 0:
        raise RuntimeError("log_mel_trace failed")
    t = np.frombuffer(buf, dtype=np.uint64).reshape(n, 8).astype(np.int64)
    t = t[t[:, 0] > 0]
    out = {"blocks": int(len(t)), "span_us": float((t[:, 1].max() - t[:, 0].min()) / 1e3),
           "block_us": [float(np.median(t[:, 1] - t[:, 0]) / 1e3),
                        float((t[:, 1] - t[:, 0]).max() / 1e3)]}
    for k, name in enumerate(("staging", "pass1", "pass23", "split", "bands")):
        c = t[:, 3 + k] - t[:, 2 + k]
        out[name + "_cycles"] = [float(np.median(c)), float(c.max())]
    return out


def profiled_ms(fn, calls: int = 8) -> float:
    """Device ms per call: torch.profiler's sum over fn's CUDA kernels and
    copies (for calls a CUDA graph cannot capture)."""
    return sum(profile(fn, calls).values()) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mels", type=int, nargs="+", default=[128])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="per-block phase times of one call (a build with -DLOGMEL_TRACE)")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("bench_log_mel: no CUDA device", file=sys.stderr)
        return 2
    from asr_finetune_tpu_torch.device import resolve_device
    from asr_finetune_tpu_torch.ops import logmel as LM
    from asr_finetune_tpu_torch.ops import logmel_fused as LF
    assert pathlib.Path(LF.__file__).resolve().is_relative_to(root), LF.__file__
    resolve_device("cuda")   # fp32 products in fp32 (no TF32)
    if args.ptxas:
        ptxas_report(root)
    if args.trace:
        load_trace_build(LF)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    resident = hasattr(LM, "device_tables")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    audio = torch.randn((args.batch, LM.CHUNK_SAMPLES), generator=g, device=dev) * 0.1
    audio[-1, 100_000:300_000] = 0.0
    window = torch.hann_window(400, periodic=True, dtype=torch.float64).float().to(dev)
    for n_mels in args.mels:
        melfb = torch.from_numpy(LM.mel_filter_bank(n_mels=n_mels)).to(dev)
        fns = {"ms": lambda: LF.log_mel_fused(audio, n_mels),
               "raw_ms": lambda: LF._log10_mel_cuda(audio, n_mels),
               "plain_ms": lambda: LF.log_mel_fused_plain(audio, n_mels),
               "conv_ms": lambda: LM.log_mel_spectrogram(audio, n_mels),
               "stft_ms": lambda: stft_log_mel(audio, window, melfb)}
        row = {"root": str(root), "batch": args.batch, "n_mels": n_mels, "card": card.strip(),
               "trace_build": args.trace,
               "timed_by": {k: "graph replay" if resident or k in ("ms", "raw_ms", "stft_ms")
                            else "profiler sum" for k in fns}}
        out = fns["ms"]()
        if args.check:
            ref = fns["plain_ms"]()
            diff = (out - ref).abs()
            tone = tonal_audio(args.batch, dev)
            f64 = log_mel_f64(tone, n_mels)
            row.update(max_abs_err=float(diff.max()),
                       rms_rel=float(diff.square().mean().sqrt() / ref.square().mean().sqrt()),
                       bit_equal=bool(torch.equal(out, fns["ms"]())),
                       finite=bool(out.isfinite().all()),
                       stft_max_abs_err=float((fns["stft_ms"]() - ref).abs().max()),
                       tonal_f64_err={
                           "kernel": float((LF.log_mel_fused(tone, n_mels) - f64).abs().max()),
                           "plain": float((LF.log_mel_fused_plain(tone, n_mels) - f64).abs().max()),
                           "conv": float((LM.log_mel_spectrogram(tone, n_mels) - f64).abs().max()),
                           "stft": float((stft_log_mel(tone, window, melfb) - f64).abs().max())})
            del tone, f64
        for k, fn in fns.items():
            row[k] = device_ms(fn, 16) if row["timed_by"][k] == "graph replay" else profiled_ms(fn)
        nbytes = audio.numel() * 4 + out.numel() * 4
        row["bound_bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        if hasattr(LF, "flops_per_frame"):
            flops = args.batch * LM.NUM_FRAMES * LF.flops_per_frame(n_mels)
            row["bound_ops_ms"] = flops / FP32_FLOPS * 1e3
        if args.trace:
            row["trace"] = trace(LF, fns["ms"])
        if args.profile:
            row["by_kernel_us"] = profile(fns["ms"])
            row["conv_by_kernel_us"] = profile(fns["conv_ms"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

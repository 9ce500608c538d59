#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (asr_finetune_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card, nvcc

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from csrc/ (one nvcc per source, in parallel);
3. holds every kernel against its plain PyTorch version at whisper-large-v3
   shapes (B=4, and the decoder kernels also at 12 rows) in bf16 and fp32,
   within the limits stated at F32_LIMITS, and times kernel, plain version and, for
   the encoder attention, F.scaled_dot_product_attention as a yardstick (the
   port never calls it): the decoder kernels over float, mixed int8/float
   and all-int8 weights; the encoder-attention forward; its backward at the
   encoder's self-attention and the teacher-forced cross-attention shapes,
   with the forward's logsumexp, and SDPA's backward as its yardstick; the
   W8A8 kernel bit for bit at the PEFT main path's six product shapes, pure
   and with the outlier keep-mask and addend, timed beside torch._int_mm (the
   int8 dot alone) and the bf16 product with the dequantized weight; the
   beam path's attention at 4 utterances x 4 beams: the ancestry-masked
   beam self-attention, the cross-attention over K/V shared per utterance
   (kv_group 4) and over int8 K/V (G = 1 and 4); both again at 2 x 10
   beams, wider than the Pallas kernels' 8; the encoder-attention kernels on
   the (BH, T, hd) layout (80 x 1536 rows, keys valid below 1500) and on one
   fused (4, 1500, 3840) qkv buffer, forward and backward, with SDPA as the
   yardstick; W8A8 also at the fused q|k|v product 1280 -> 3840; the log-mel
   kernel (fp32) at B 4, 80 and 128 mels, the production conv form
   (ops/logmel.log_mel_spectrogram) as its yardstick;
4. runs an fp32 greedy decode at large-v3 width and 2+2 layers through the
   fused kernels and through the plain decode step: the tokens must be equal,
   over a float base and over a merged int8 base; a beam-4 decode the same
   way (fused == plain, also over int8 cross K/V, and the cache-reorder
   path == the ancestry path); one fp32 train step at that
   size: its gradients through the attention kernels must equal those
   through plain attention, and with remat on those with it off; and one
   fp32 PEFT step over an int8 base: adapter gradients through the W8A8
   kernel against its plain version, and over the dequantized base through
   the attention kernels against plain attention; the fused-qkv encoder path
   (ASR_TPU_FUSED_QKV=1) against the three projections, and the (BH, T, hd)
   layout (ASR_TPU_DENSE_PACKED=0) against the packed one, at the same size:
   the encoder output, a full fine-tuning step's gradients and a PEFT step's
   adapter gradients over the dequantized int8 base with lora dropout;
5. the serving main path: transcribes four seeded synthetic 16 kHz wavs (one
   longer than 30 s) with `asr_finetune_tpu_torch.cli.transcribe` at
   large-v3 (32+32 layers, random weights from a seed, bf16), asserts every
   kernel's launch count against the count the path implies, prints
   utterances/s, ms/step and peak memory; then the same with beam-4
   (`--generation_num_beams 4`: 16 hypothesis rows over cross K/V held at
   the 4 utterances' rows), with `--decode_kv_int8`, and with the cache
   reordered each step (ASR_TPU_BEAM_REORDER=1); greedy again under
   ASR_TPU_FUSED_QKV=1 (the encoder through the fused-qkv kernel); the
   offline evaluator with beam-4 over four seeded wavs, stopped after one
   batch and resumed;
6. the training main path: `asr_finetune_tpu_torch.cli.train` with the
   repo's largev3_debug.config, whisper-large-v3 full fine-tuning (32+32
   layers, bf16 compute, fp32 masters, remat), 4 steps of batch 4 on 20
   seeded wavs, eval with WER and a checkpoint; asserts the results and the
   launch counts, prints ms/step, utterances/s, tokens/s, peak memory, the
   checkpoint's write time, one step's device time by CUDA kernel, and
   that step's attention-backward and W8A8 device ms beside the step time
   and idle share;
7. the PEFT main path: `cli.train` with the repo's largev3_peft_debug.config
   and --int8_matmul (AdaLoRA rank 8 on every q/v, int8 frozen base, every
   frozen product through the W8A8 kernel, the outlier calibration, eval
   decode through the int8 options of the decoder kernels, an adapter-only
   checkpoint), the same 20 wavs and cut; the same assertions and figures,
   the calibrated outlier columns; then the same under ASR_TPU_FUSED_QKV=1
   (7b): every encoder layer's q/k/v as one W8A8 product of 1280 -> 3840 in
   its dynamic top-k outlier form (the calibration stays unfused, as the JAX
   trial's, and records no such class) into the fused-qkv attention kernel,
   forward and backward;
8. one decode step's device time by CUDA kernel, greedy and on each beam
   path, with the launches per step asserted; then the card line again,
   one JSON line `{"kernels": [...]}`, and last `{"ok": true, "device": {...}}`.

Any failed check raises: the script then exits non-zero and prints no
result line. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

# H100 SXM data sheet (dense): the rates a bound is reckoned against
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
B, D, H, FF, L = 4, 1280, 20, 5120, 32          # whisper-large-v3, batch 4
T_ENC, S_PAD = 1500, 1536                        # encoder frames, padded source
SELF_T, SELF_POS = 128, 63                       # main-path cache, last step of 64
CROSS_TQ = 192                                   # training label bucket of the main path
TRAIN_CONFIG = "asr_finetune_tpu/configs/largev3_debug.config"
PEFT_CONFIG = "asr_finetune_tpu/configs/largev3_peft_debug.config"
TRAIN_STEPS, TRAIN_UTTS, TRAIN_GEN_LEN = 4, 20, 32
# the W8A8 products of the PEFT main path (batch 4): encoder rows B x 1500,
# decoder rows B x the 192 label bucket
W8A8_SHAPES = (("encoder q/k/v/o", B * T_ENC, D, D), ("encoder fc1", B * T_ENC, D, FF),
               ("encoder fc2", B * T_ENC, FF, D), ("decoder q/k/v/o", B * CROSS_TQ, D, D),
               ("decoder fc1", B * CROSS_TQ, D, FF), ("decoder fc2", B * CROSS_TQ, FF, D),
               ("encoder q|k|v fused", B * T_ENC, D, 3 * D))
T_PAD = 1536                                     # T_ENC padded to 128 ((BH, T, hd) layout)
# fp32 gradients of one train step at large-v3 width, 2+2 layers: the
# largest over the leaves of max |diff| / max |grad|, kernels against plain
# attention and remat on against off. Each limit is ~4x (kernels) and ~10x
# (remat: cuBLAS may reorder the recomputed products, and the reading moved
# 4.7e-8 -> 9.4e-8 between two runs) the largest reading on an H100 (PERF.md).
GRAD_LIMITS = {"kernels vs plain": 6e-6, "remat vs not": 1e-6}
# one fp32 PEFT step over the int8 base, 2+2 layers: with W8A8, the kernel
# against its plain version changes no bit, so no gradient either; over the
# base dequantized (no int8 rounding of activations, which would turn the
# attention kernels' last-bit differences into steps of 1/127 of a row's
# amax), the attention kernels against plain attention, ~4x the largest
# reading on an H100 (7.9e-6, PERF.md)
PEFT_GRAD_LIMITS = {"w8a8 kernel vs plain": 0.0, "attention kernels vs plain": 3.2e-5}
# Limits against the plain version on the same inputs. fp32: |err| <= 1e-4 +
# 1e-4|ref| (the sums run in another order) and RMS(err) <= 1e-5 RMS(ref).
# bf16: |err| <= atol + 2^-7|ref|: the kernel and its plain version round
# the same intermediates to bf16, so an output at a rounding boundary may
# land one bf16 step (at most 2^-7 of its value) apart; atol bounds what
# reaches the output beyond that step from flips upstream. And RMS(err) <=
# rms_rel x RMS(ref), which a systematic fault (a wrong mask, tile or row
# group) breaks long before it breaks the max. Both bf16 limits, per kernel,
# are 4x the largest reading on an H100 over B=4 and 12 rows and over the
# seeded inputs each has had (PERF.md), atol no less than 1e-5. An RMS ratio
# counts a handful of outputs a bf16 step apart, so it moves with the inputs:
# fused_qkv read 1e-6 and then 7.9e-6, the int8-weight self-attention 0 and
# then 1.5e-4.
F32_LIMITS = (1e-4, 1e-4, 1e-5)          # (atol, rtol, rms_rel), every kernel
BF16_RTOL = 2.0 ** -7
BF16_LIMITS = {                          # kernel: (atol, rms_rel)
    "fused_qkv": (1e-5, 3.2e-5),
    "fused_attn_self": (4e-4, 6e-4),
    "fused_attn_cross": (1.2e-3, 2.7e-3),
    "fused_mlp": (2e-4, 6e-4),
    "encoder_attention": (2.1e-3, 9.2e-3),
    "encoder_attention_bwd": (1.1e-3, 6.8e-4),
    "fused_qkv_int8": (1e-5, 1.3e-4),
    "fused_attn_self_int8": (5.3e-5, 6e-4),
    "fused_attn_cross_int8": (1.3e-3, 2.8e-3),
    "fused_mlp_int8": (7.1e-5, 3.5e-4),
    # the beam slice's attention options (4 utterances x 4 beams), the same
    # rule over their first readings on an H100
    "fused_attn_beam": (1.5e-4, 1.6e-4),
    "fused_attn_beam_int8": (1.3e-4, 1.6e-4),
    "fused_attn_cross_group": (1.3e-3, 2.7e-3),
    "fused_attn_cross_group_int8": (1.4e-3, 2.8e-3),
    "fused_attn_cross_kv8": (9.3e-4, 2.8e-3),
    "fused_attn_cross_kv8_int8": (1.3e-3, 2.6e-3),
    "fused_attn_cross_group_kv8": (1.4e-3, 2.8e-3),
    "fused_attn_cross_group_kv8_int8": (1.4e-3, 2.7e-3),
    # the encoder-attention kernels on the (BH, T, hd) and fused-qkv
    # layouts at the encoder's shape, the same rule
    "encoder_attention_bh": (1.7e-3, 9.2e-3),
    "encoder_attention_bh_bwd": (2.4e-3, 6.9e-4),
    "encoder_attention_qkv": (1.7e-3, 9.2e-3),
    "encoder_attention_qkv_bwd": (1.8e-3, 6.6e-4),
}
# fp32 at large-v3 width, 2+2 layers: the largest over the outputs or leaves
# of max |diff| / max |ref|, the fused-qkv path against the three
# projections and the (BH, T, hd) layout against the packed one: 4x the
# largest first reading on an H100 (full FT 5.2e-7, PEFT 3.4e-7; the encoder
# output read 0), and no less than 1e-6, the remat check's size (cuBLAS may
# order an fp32 product's sums otherwise)
LAYOUT_LIMITS = {"encoder output": 1e-6, "full-FT gradients": 2.1e-6,
                 "PEFT adapter gradients": 1.4e-6}
ATTN_CROSS = ("fused_attn_cross", "fused_attn_cross_group", "fused_attn_cross_kv8",
              "fused_attn_cross_group_kv8")
REPLACES = {
    "encoder_attention": "asr_finetune_tpu/ops/encoder_attention.py:286",
    "encoder_attention_bwd": "asr_finetune_tpu/ops/encoder_attention.py:311",
    "fused_qkv": "asr_finetune_tpu/ops/decoder_fused.py:150",
    "fused_attn_self": "asr_finetune_tpu/ops/decoder_fused.py:310",
    **{k: "asr_finetune_tpu/ops/decoder_fused.py:310" for k in ATTN_CROSS},
    "fused_attn_beam": "asr_finetune_tpu/ops/decoder_fused.py:548",
    "fused_mlp": "asr_finetune_tpu/ops/decoder_fused.py:681",
    "w8a8": "asr_finetune_tpu/ops/w8a8_fused.py:93",
    "encoder_attention_bh": "asr_finetune_tpu/ops/encoder_attention.py:133",
    "encoder_attention_bh_bwd": "asr_finetune_tpu/ops/encoder_attention.py:156",
    "encoder_attention_qkv": "asr_finetune_tpu/ops/encoder_attention.py:457",
    "encoder_attention_qkv_bwd": "asr_finetune_tpu/ops/encoder_attention.py:484",
    "log_mel": "asr_finetune_tpu/ops/logmel_pallas.py:123",
}
REPLACES.update({k + "_int8": v for k, v in list(REPLACES.items()) if k.startswith("fused_")})
SOURCES = {
    **{k: "asr_finetune_tpu_torch/csrc/encoder_attention.cu"
       for k in REPLACES if k.startswith("encoder_attention")},
    "log_mel": "asr_finetune_tpu_torch/csrc/logmel.cu",
    **{k: "asr_finetune_tpu_torch/csrc/decoder_fused.cu"
       for k in REPLACES if k.startswith("fused_")},
    "w8a8": "asr_finetune_tpu_torch/csrc/w8a8.cu",
}
DECODER = ("fused_qkv", "fused_attn_self", "fused_attn_cross", "fused_mlp")
BEAMS = 4                                        # the beam path's num_beams
WIDE_BEAMS = 10                                  # beyond the Pallas kernels' 8
# the decoder kernels each decode step of a path runs once a layer
BEAM_DECODER = ("fused_qkv", "fused_attn_beam", "fused_attn_cross_group", "fused_mlp")
BEAM_KV8_DECODER = ("fused_qkv", "fused_attn_beam", "fused_attn_cross_group_kv8", "fused_mlp")
REORDER_DECODER = ("fused_qkv", "fused_attn_self", "fused_attn_cross_group", "fused_mlp")
# the decoder kernels' weights in phase 3a: the projections that are int8
# ({w_q8, w_scale}); "mixed" is a merged-LoRA int8 base (q, v float)
WEIGHT_KINDS = {"float": (), "mixed": ("k", "o", "fc1", "fc2"),
                "all-int8": ("q", "k", "v", "o", "fc1", "fc2")}


def _kernel_modules() -> tuple:
    from asr_finetune_tpu_torch.ops import decoder_fused as DF
    from asr_finetune_tpu_torch.ops import encoder_attention as EA
    from asr_finetune_tpu_torch.ops import logmel_fused as LF
    from asr_finetune_tpu_torch.ops import w8a8_fused as WF
    return EA, DF, WF, LF


def all_launches() -> dict:
    """Every kernel wrapper's launch count."""
    return {k: v for mod in _kernel_modules() for k, v in mod.LAUNCHES.items()}


def reset_all_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def expect_launches(**counts) -> dict:
    """Every kernel's expected launch count: `counts`, and 0 for the rest."""
    return {k: counts.get(k, 0) for k in all_launches()}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def eager_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time per eager call of fn(), by CUDA events: when the host
    launches slower than the device runs, this is the host's time."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int, replays: int = 5) -> float:
    """Device time per call of fn(): `calls` calls captured in one CUDA
    graph, the graph replayed and timed by CUDA events, so the host's launch
    overhead is not in the number."""
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
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def compare(name, out, ref, dtype_name):
    """Holds out against ref (tuples compared element by element) within the
    limits above for kernel `name`. Prints the readings and returns the max
    abs error and the RMS error over the RMS of ref."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = excess = rms_rel = 0.0
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        if not bool(o.isfinite().all()):
            raise AssertionError(f"{name} [{dtype_name}]: non-finite output")
        diff = (o - r).abs()
        if dtype_name == "float32":
            atol, rtol, rel_max = F32_LIMITS
        else:
            (atol, rel_max), rtol = BF16_LIMITS[name], BF16_RTOL
        over = diff - rtol * r.abs()
        bad = over > atol
        rel = float(diff.square().mean().sqrt() / r.square().mean().sqrt())
        if bool(bad.any()) or rel > rel_max:
            raise AssertionError(
                f"{name} [{dtype_name}]: {int(bad.sum())} elements off, max abs "
                f"err {float(diff.max()):.3e}, max excess over {rtol:.3g}|ref| "
                f"{float(over.max()):.3e} (atol {atol}), RMS err / RMS ref "
                f"{rel:.3e} (limit {rel_max})")
        err = max(err, float(diff.max()))
        excess = max(excess, float(over.max()))
        rms_rel = max(rms_rel, rel)
    print(f"{name} [{dtype_name}]: max abs err {err:.3e}, max excess over the "
          f"rounding step {excess:.3e}, RMS err / RMS ref {rms_rel:.3e}")
    return err, rms_rel


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    """Bytes of the tensors, each counted once (an int8 weight at one byte an
    element); None is skipped."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def time_row(rows, name, err, fn, plain_fn, moved, flops, dtype_name,
             library_fn=None, calls=64):
    """Times fn (the kernel wrapper), plain_fn and library_fn on the device,
    fn also eagerly, and records kernel `name`'s JSON row; the bound is that
    of `moved` bytes and `flops` operations of dtype_name."""
    ms = device_ms(fn, calls)
    eager = eager_ms(fn, calls)
    plain_ms = device_ms(plain_fn, max(calls // 8, 2))
    library_ms = None if library_fn is None else device_ms(library_fn, calls)
    b_ms, b_by = bound(moved, flops, dtype_name)
    rows[name] = {"name": name, "route": "cuda", "source": SOURCES[name],
                  "replaces": REPLACES[name], "launches": 0,
                  "max_abs_err": err[0], "rms_rel_err": err[1],
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "library_ms": library_ms}
    print(f"  {name} [{dtype_name}] kernel {ms:.4f} ms (device; eager call "
          f"{eager:.4f} ms)  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
          + ("" if library_ms is None else f"  library {library_ms:.4f} ms"))


def decoder_calls(DF, x, q, w, b, ln, kv, pos, stacked):
    """The four decoder kernels on x's rows: {name: (kernel fn(layer), plain
    fn, operands read, flops)}. w {projection: (weight, int8 scale or
    None)}, b {projection: bias} and ln (scale, bias) are stacked over L
    layers; the kernel reads them at `layer` in place (stacked) or is handed
    layer L-1's (`layer` ignored), the plain version layer L-1's. kv
    {"self", "cross"}: (k, v) caches, (L, rows, T, d) when stacked, else
    (rows, T, d); the self-attention sees keys 0..pos."""
    li, n, nv = L - 1, x.shape[0], pos + 1
    w1 = {k: (t[li], None if s is None else s[li]) for k, (t, s) in w.items()}
    b1 = {k: t[li] for k, t in b.items()}
    ln1 = tuple(t[li] for t in ln)
    kv1 = {k: tuple(t[li] for t in pair) if stacked else pair for k, pair in kv.items()}
    (ks, vs), (kx, vx) = kv1["self"], kv1["cross"]

    def op(layer):
        return (w, b, ln, kv, layer) if stacked else (w1, b1, ln1, kv1, None)

    def qkv(layer):
        w_, b_, ln_, _, l = op(layer)
        return DF.fused_qkv(x, *ln_, w_["q"][0], b_["q"], w_["k"][0], w_["v"][0], b_["v"],
                            wq_scale=w_["q"][1], wk_scale=w_["k"][1], wv_scale=w_["v"][1],
                            layer_idx=l)

    def attn_self(layer):
        w_, b_, _, kv_, l = op(layer)
        return DF.fused_attn(x, *kv_["self"], w_["o"][0], b_["o"], q=q, pos=pos,
                             wo_scale=w_["o"][1], layer_idx=l)

    def attn_cross(layer):
        w_, b_, ln_, kv_, l = op(layer)
        return DF.fused_attn(x, *kv_["cross"], w_["o"][0], b_["o"], s_valid=T_ENC,
                             ln_scale=ln_[0], ln_bias=ln_[1], wq=w_["q"][0], bq=b_["q"],
                             wq_scale=w_["q"][1], wo_scale=w_["o"][1], layer_idx=l)

    def mlp(layer):
        w_, b_, ln_, _, l = op(layer)
        return DF.fused_mlp(x, *ln_, w_["fc1"][0], b_["fc1"], w_["fc2"][0], b_["fc2"],
                            w1_scale=w_["fc1"][1], w2_scale=w_["fc2"][1], layer_idx=l)

    return {
        "fused_qkv": (
            qkv,
            lambda: DF.fused_qkv_plain(x, *ln1, w1["q"][0], b1["q"], w1["k"][0], w1["v"][0],
                                       b1["v"], wq_scale=w1["q"][1], wk_scale=w1["k"][1],
                                       wv_scale=w1["v"][1]),
            (x, *ln1, *w1["q"], b1["q"], *w1["k"], *w1["v"], b1["v"]), 2 * n * D * 3 * D),
        "fused_attn_self": (
            attn_self,
            lambda: DF.fused_attn_plain(x, ks, vs, w1["o"][0], b1["o"], q=q, n_valid=nv,
                                        wo_scale=w1["o"][1]),
            (x, q, ks[:, :nv], vs[:, :nv], *w1["o"], b1["o"]),
            2 * 2 * n * nv * D + 2 * n * D * D),
        "fused_attn_cross": (
            attn_cross,
            lambda: DF.fused_attn_plain(x, kx, vx, w1["o"][0], b1["o"], n_valid=T_ENC,
                                        ln_scale=ln1[0], ln_bias=ln1[1], wq=w1["q"][0],
                                        bq=b1["q"], wq_scale=w1["q"][1], wo_scale=w1["o"][1]),
            (x, *ln1, *w1["q"], b1["q"], kx[:, :T_ENC], vx[:, :T_ENC], *w1["o"], b1["o"]),
            2 * 2 * n * D * D + 2 * 2 * n * T_ENC * D),
        "fused_mlp": (
            mlp,
            lambda: DF.fused_mlp_plain(x, *ln1, w1["fc1"][0], b1["fc1"], w1["fc2"][0],
                                       b1["fc2"], w1_scale=w1["fc1"][1],
                                       w2_scale=w1["fc2"][1]),
            (x, *ln1, *w1["fc1"], b1["fc1"], *w1["fc2"], b1["fc2"]), 2 * 2 * n * D * FF),
    }


def beam_calls(DF, x, q, x4, w, b, ln, beam_kv, anc, cross, cross8):
    """The beam slice's attention calls, decoder_calls' form: beam
    self-attention over the unpermuted (L, 16, T, d) cache through the
    ancestry map `anc` (4, 4, T) at pos SELF_POS; the cross-attention of
    x's 16 rows over the 4 KV rows of `cross` (kv_group 4), of x4's 4 rows
    over int8 K/V (`cross8`: k_q8, v_q8, k_scale_d, v_scale_d) and of the 16
    rows over int8 K/V. Bytes read: each live cache row at each position
    once (the distinct rows the ancestry names), the K/V below s_valid."""
    li, nv = L - 1, SELF_POS + 1
    w1 = {k: (t[li], None if s is None else s[li]) for k, (t, s) in w.items()}
    b1 = {k: t[li] for k, t in b.items()}
    ln1 = tuple(t[li] for t in ln)
    kb, vb = beam_kv
    beams = anc.shape[1]
    live = sum(len(set(anc[u, :, t].tolist())) for u in range(anc.shape[0]) for t in range(nv))
    n = x.shape[0]
    calls = {"fused_attn_beam": (
        lambda layer: DF.fused_attn_beam(x, kb, vb, w["o"][0], b["o"], q=q, pos=SELF_POS,
                                         ancestry=anc, wo_scale=w["o"][1], layer_idx=layer),
        lambda: DF.fused_attn_beam_plain(x, kb[li], vb[li], w1["o"][0], b1["o"], q, SELF_POS,
                                         anc, w1["o"][1]),
        (x, q, anc[:, :, :nv], *w1["o"], b1["o"]), 2 * 2 * n * nv * D + 2 * n * D * D,
        2 * live * D * kb.element_size())}

    def cross_call(xr, kv, scales, group):
        k_, v_ = kv
        ks, vs = scales

        def fn(layer):
            return DF.fused_attn(xr, k_, v_, w["o"][0], b["o"], s_valid=T_ENC,
                                 ln_scale=ln[0], ln_bias=ln[1], wq=w["q"][0], bq=b["q"],
                                 k_scale=ks, v_scale=vs, wq_scale=w["q"][1],
                                 wo_scale=w["o"][1], layer_idx=layer, kv_group=group)

        def plain():
            return DF.fused_attn_plain(
                xr, k_[li], v_[li], w1["o"][0], b1["o"], n_valid=T_ENC, ln_scale=ln1[0],
                ln_bias=ln1[1], wq=w1["q"][0], bq=b1["q"], wq_scale=w1["q"][1],
                wo_scale=w1["o"][1], k_scale=None if ks is None else ks[li],
                v_scale=None if vs is None else vs[li], kv_group=group)
        m = xr.shape[0]
        reads = (xr, *ln1, *w1["q"], b1["q"], k_[li][:, :T_ENC], v_[li][:, :T_ENC],
                 None if ks is None else ks[li], None if vs is None else vs[li],
                 *w1["o"], b1["o"])
        return fn, plain, reads, 2 * 2 * m * D * D + 2 * 2 * m * T_ENC * D, 0

    calls["fused_attn_cross_group"] = cross_call(x, cross, (None, None), beams)
    calls["fused_attn_cross_kv8"] = cross_call(x4, cross8[:2], cross8[2:], 1)
    calls["fused_attn_cross_group_kv8"] = cross_call(x, cross8[:2], cross8[2:], beams)
    return calls


def int8_cross(cross, dt):
    """The main path's int8 cross K/V from float (L, B, S_PAD, D) k/v:
    W.quantize_cross_kv, laid out by decode._prepare_fused: (k_q8, v_q8,
    k_scale_d, v_scale_d)."""
    from asr_finetune_tpu_torch.evaluation import decode as D_
    from asr_finetune_tpu_torch.models import whisper as W
    heads = {n: t.view(L, B, S_PAD, H, 64) for n, t in zip("kv", cross)}
    q8, _, _ = D_._prepare_fused(cross[0][0], W.quantize_cross_kv(heads), SELF_T, dt)
    return q8["k_q8"], q8["v_q8"], q8["k_scale_d"], q8["v_scale_d"]


def check_decoder_kernels(rows):
    """Phase 3a: the four decoder kernels against their plain versions at
    whisper-large-v3 shapes, bf16 and fp32, over each kind of weights in
    WEIGHT_KINDS: float, and int8 with per-channel scales, mixed as the PEFT
    eval decode has them or all int8. At B=4 with stacked weights read at
    layer 31 of 32: the self-attention at pos 0, 127, 200 of a 256 cache
    and at the main path's cache 128, pos 63; the cross-attention at S 1536,
    s_valid 1500. At 12 rows (the GEMVs run them as a group of 8 and one of
    4) with one layer's weights unstacked. In bf16 the main path's shapes
    (B=4) are timed with the calls cycling through the 32 layers, against
    a bound that counts each operand read and each output written once:
    float weights give the "fused_*" rows, mixed the "fused_*_int8" rows.
    The beam path's calls (beam_calls) at 4 utterances x 4 beams: the beam
    self-attention through a random ancestry map, the cross-attention with
    kv_group 4, with int8 K/V at 4 rows (G = 1) and at 16 (G = 4), each
    checked in both dtypes over every weight kind and timed as above. The
    beam self-attention and the grouped cross-attention (float and int8
    K/V) at 2 x WIDE_BEAMS rows, float weights, checked in both dtypes."""
    import torch
    from asr_finetune_tpu_torch.ops import decoder_fused as DF
    from asr_finetune_tpu_torch.ops import quant as Q

    dev, f32 = torch.device("cuda"), torch.float32
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(0)

        def rn(*shape, scale=1.0, dtype=dt):
            return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

        ln = (1 + rn(L, D, scale=0.1, dtype=f32), rn(L, D, scale=0.1, dtype=f32))
        w32 = {k: rn(L, D, D, scale=D ** -0.5, dtype=f32) for k in "qkvo"}
        w32["fc1"] = rn(L, D, FF, scale=D ** -0.5, dtype=f32)
        w32["fc2"] = rn(L, FF, D, scale=FF ** -0.5, dtype=f32)
        b = {k: rn(L, FF if k == "fc1" else D, scale=0.1) for k in ("q", "v", "o", "fc1", "fc2")}
        x, q = rn(B, D), rn(B, D, scale=0.125, dtype=f32)
        cross = (rn(L, B, S_PAD, D), rn(L, B, S_PAD, D))
        kv = {256: {"self": (rn(L, B, 256, D), rn(L, B, 256, D)), "cross": cross},
              B: {"self": (rn(L, B, SELF_T, D), rn(L, B, SELF_T, D)), "cross": cross},
              12: {"self": (rn(12, SELF_T, D), rn(12, SELF_T, D)),
                   "cross": (rn(12, S_PAD, D), rn(12, S_PAD, D))}}
        x12, q12 = rn(12, D), rn(12, D, scale=0.125, dtype=f32)
        # the beam path: 4 utterances x BEAMS hypotheses
        xb, qb = rn(B * BEAMS, D), rn(B * BEAMS, D, scale=0.125, dtype=f32)
        beam_kv = (rn(L, B * BEAMS, SELF_T, D), rn(L, B * BEAMS, SELF_T, D))
        anc = torch.randint(0, BEAMS, (B, BEAMS, SELF_T), generator=g, device=dev,
                            dtype=torch.int32)
        cross8 = int8_cross(cross, dt)
        for kind, int8 in WEIGHT_KINDS.items():
            w = {}
            for k, t in w32.items():
                qw = Q.quantize_weight(t) if k in int8 else None
                w[k] = (t.to(dt), None) if qw is None else (qw[Q.QUANT_KEY], qw[Q.SCALE_KEY])
            sfx = "_int8" if int8 else ""
            for pos in (0, 127, 200):
                fn, plain, _, _ = decoder_calls(DF, x, q, w, b, ln, kv[256], pos,
                                                True)["fused_attn_self"]
                print(f"fused_attn self, {kind} weights [{dn}] cache 256 pos {pos}:")
                compare("fused_attn_self" + sfx, fn(L - 1), plain(), dn)
            for n_rows, xr, qr in ((B, x, q), (12, x12, q12)):
                print(f"decoder kernels, {kind} weights [{dn}] at {n_rows} rows (self "
                      f"cache {SELF_T} pos {SELF_POS}, cross S {S_PAD} s_valid {T_ENC}):")
                calls = decoder_calls(DF, xr, qr, w, b, ln, kv[n_rows], SELF_POS, n_rows == B)
                for name, (fn, plain, reads, flops) in calls.items():
                    out = fn(L - 1)
                    err = compare(name + sfx, out, plain(), dn)
                    if dt is torch.bfloat16 and n_rows == B and kind != "all-int8":
                        it = iter(range(10 ** 9))
                        time_row(rows, name + sfx, err, lambda: fn(next(it) % L), plain,
                                 nbytes(*reads) + nbytes(*(out if isinstance(out, tuple)
                                                           else (out,))), flops, dn)
            print(f"beam-path attention, {kind} weights [{dn}] at {B} x {BEAMS} rows (beam "
                  f"cache {SELF_T} pos {SELF_POS}, cross kv_group {BEAMS} and int8 K/V):")
            calls = beam_calls(DF, xb, qb, x, w, b, ln, beam_kv, anc, cross, cross8)
            for name, (fn, plain, reads, flops, extra_bytes) in calls.items():
                out = fn(L - 1)
                err = compare(name + sfx, out, plain(), dn)
                if dt is torch.bfloat16 and kind != "all-int8":
                    it = iter(range(10 ** 9))
                    time_row(rows, name + sfx, err, lambda: fn(next(it) % L), plain,
                             nbytes(*reads, out) + extra_bytes, flops, dn)
            del w
        if dt is torch.bfloat16:
            # the fixed cost of a GEMV launch: fused_mlp at ff=16 is two
            # near-empty GEMV launches (the LN prologue, reduction, epilogue)
            w1e, b1e = rn(L, D, 16, scale=D ** -0.5), rn(L, 16, scale=0.1)
            w2e = rn(L, 16, D, scale=0.25)
            it = iter(range(10 ** 9))
            ms = device_ms(lambda: DF.fused_mlp(x, *ln, w1e, b1e, w2e, b["fc2"],
                                                layer_idx=next(it) % L), 64)
            print(f"  fused_mlp at ff=16 (two near-empty GEMV launches) [{dn}]: "
                  f"{ms:.4f} ms")
        # beams wider than the Pallas kernels' 8: 2 utterances x WIDE_BEAMS
        # (a block serves 8 query rows of a KV row, then 2), float weights,
        # layer L-1 unstacked
        nw, li = 2 * WIDE_BEAMS, L - 1
        print(f"wide beams [{dn}]: 2 x {WIDE_BEAMS} rows, beam cache {SELF_T} pos "
              f"{SELF_POS}, cross kv_group {WIDE_BEAMS}, float and int8 K/V:")
        xw, qw = rn(nw, D), rn(nw, D, scale=0.125, dtype=f32)
        kw, vw = rn(nw, SELF_T, D), rn(nw, SELF_T, D)
        ancw = torch.randint(0, WIDE_BEAMS, (2, WIDE_BEAMS, SELF_T), generator=g,
                             device=dev, dtype=torch.int32)
        wo1, bo1 = w32["o"][li].to(dt), b["o"][li]
        compare("fused_attn_beam",
                DF.fused_attn_beam(xw, kw, vw, wo1, bo1, q=qw, pos=SELF_POS, ancestry=ancw),
                DF.fused_attn_beam_plain(xw, kw, vw, wo1, bo1, qw, SELF_POS, ancw), dn)
        cq = dict(ln_scale=ln[0][li], ln_bias=ln[1][li], wq=w32["q"][li].to(dt), bq=b["q"][li])
        for name, (k_, v_, ks, vs) in (
                ("fused_attn_cross_group", (cross[0][li, :2], cross[1][li, :2], None, None)),
                ("fused_attn_cross_group_kv8", tuple(t[li, :2] for t in cross8))):
            compare(name, DF.fused_attn(xw, k_, v_, wo1, bo1, s_valid=T_ENC, k_scale=ks,
                                        v_scale=vs, kv_group=WIDE_BEAMS, **cq),
                    DF.fused_attn_plain(xw, k_, v_, wo1, bo1, n_valid=T_ENC, k_scale=ks,
                                        v_scale=vs, kv_group=WIDE_BEAMS, **cq), dn)
        del w32, kv, cross, beam_kv, cross8, kw, vw
        torch.cuda.empty_cache()


def check_encoder_attention(rows):
    """Phase 3b: the encoder-attention forward against its plain version at
    T=1500 (and s_valid 1000), bf16 and fp32; bf16 timed beside
    F.scaled_dot_product_attention as a yardstick (the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from asr_finetune_tpu_torch.ops import encoder_attention as EA

    dev = torch.device("cuda")
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(1)
        qe, ke, ve = ((torch.randn((B, T_ENC, D), generator=g, device=dev)).to(dt)
                      for _ in range(3))
        out = EA.dense_attention_packed(qe, ke, ve, 64, T_ENC)
        ref = EA.dense_attention_packed_plain(qe, ke, ve, 64, T_ENC)
        print(f"encoder_attention [{dn}] T {T_ENC}:")
        err = compare("encoder_attention", out, ref, dn)
        # s_valid < T masks the tail as the JAX kernel does
        out = EA.dense_attention_packed(qe, ke, ve, 64, 1000)
        ref = EA.dense_attention_packed_plain(qe, ke, ve, 64, 1000)
        print(f"encoder_attention [{dn}] T {T_ENC} s_valid 1000:")
        compare("encoder_attention", out, ref, dn)
        if dt is torch.bfloat16:
            heads = [a.view(B, T_ENC, H, 64).transpose(1, 2) for a in (qe, ke, ve)]
            time_row(rows, "encoder_attention", err,
                     lambda: EA.dense_attention_packed(qe, ke, ve, 64, T_ENC),
                     lambda: EA.dense_attention_packed_plain(qe, ke, ve, 64, T_ENC),
                     4 * B * T_ENC * D * dt.itemsize, 4 * B * H * T_ENC * T_ENC * 64, dn,
                     library_fn=lambda: F.scaled_dot_product_attention(*heads), calls=8)
        del qe, ke, ve, out, ref
        torch.cuda.empty_cache()


def kernel_times(prof, calls: int) -> list:
    """(device ms per call, launches per call, name) of every CUDA kernel in
    a torch.profiler run of `calls` calls, largest first. Only the kernels
    themselves: CPU ops such as aten::copy_ also carry their kernels' device
    time and would count it twice."""
    from torch.autograd import DeviceType
    return sorted(((e.self_device_time_total / calls / 1e3, e.count / calls, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)


def host_times(prof) -> list:
    """(host ms, calls, name) of every CPU-side event of a torch.profiler
    run by its self time, largest first: the aten ops' Python-free C++ time
    and the CUDA runtime calls (launches, synchronisations, allocations)."""
    from torch.autograd import DeviceType
    return sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0),
                  reverse=True)


def host_usage() -> np.ndarray:
    """[CPU s of this thread, CPU s of the process (all threads: autograd
    runs a CUDA backward on a thread of its own), s in Python's garbage
    collector, full (generation 2) collections]: a step's difference says
    where its host time goes."""
    import gc
    if _gc_timer not in gc.callbacks:
        gc.callbacks.append(_gc_timer)
    return np.array([time.thread_time(), time.process_time(), _GC["s"], _GC["full"]],
                    dtype=np.float64)


_GC = {"s": 0.0, "full": 0, "t0": 0.0}


def _gc_timer(phase: str, info: dict) -> None:
    if phase == "start":
        _GC["t0"] = time.perf_counter()
    else:
        _GC["s"] += time.perf_counter() - _GC["t0"]
        _GC["full"] += info["generation"] == 2


def host_usage_text(u) -> str:
    return (f"main thread on a CPU {1e3 * u[0]:.3f} ms, all threads {1e3 * u[1]:.3f} ms, "
            f"garbage collection {1e3 * u[2]:.3f} ms ({u[3]:g} full collections)")


def profiled_ms(fn, calls: int = 8) -> float:
    """Device time per call of fn(): the sum of its CUDA kernels' time under
    torch.profiler (for work a CUDA graph cannot capture, such as an autograd
    backward of a graph recorded outside the capture)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(ms for ms, _, _ in kernel_times(prof, calls))


def check_attention_bwd(rows):
    """Phase 3c: the encoder-attention backward kernel against its plain
    version at whisper-large-v3 shapes (B=4, 20 heads of 64): the encoder's
    self-attention (T 1500, and s_valid 1000) and the teacher-forced
    cross-attention (Tq 192, the label bucket of the main path, Tk 1500), in
    bf16 and fp32; the forward's logsumexp against the plain one. In bf16,
    times the kernel, the plain backward and, as a yardstick the port never
    calls, the backward of F.scaled_dot_product_attention (flash) on a
    retained graph."""
    import torch
    import torch.nn.functional as F
    from asr_finetune_tpu_torch.ops import encoder_attention as EA

    dev = torch.device("cuda")
    timed = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(4)
        worst = (0.0, 0.0)
        for shape, Tq, Tk in (("self", T_ENC, T_ENC), ("cross", CROSS_TQ, T_ENC)):
            q, do = ((torch.randn((B, Tq, D), generator=g, device=dev)).to(dt)
                     for _ in range(2))
            k, v = ((torch.randn((B, Tk, D), generator=g, device=dev)).to(dt)
                    for _ in range(2))
            for s_valid in ((Tk, 1000) if shape == "self" else (Tk,)):
                print(f"encoder_attention_bwd [{dn}] {shape} Tq {Tq} Tk {Tk} "
                      f"s_valid {s_valid}:")
                _, lse = EA._dense_attention_packed_cuda(q, k, v, 64, s_valid,
                                                         with_lse=True)
                compare("encoder_attention_lse", lse,
                        EA.attention_lse_plain(q, k, 64, s_valid), "float32")
                grads = EA._dense_attention_packed_bwd_cuda(q, k, v, do, lse, 64,
                                                            s_valid)
                err = compare("encoder_attention_bwd", grads,
                              EA.dense_attention_packed_bwd_plain(q, k, v, do, 64,
                                                                  s_valid), dn)
                again = EA._dense_attention_packed_bwd_cuda(q, k, v, do, lse, 64, s_valid)
                print(f"  two calls: dq bit-equal {torch.equal(again[0], grads[0])} (bf16: "
                      f"fp32 reduce-adds in run-to-run order), dk and dv bit-equal "
                      f"{torch.equal(again[1], grads[1]) and torch.equal(again[2], grads[2])}")
                del again
                worst = tuple(max(a, b) for a, b in zip(worst, err))
                del grads
            if dt is torch.bfloat16:
                qh, kh, vh = (a.view(B, -1, H, 64).transpose(1, 2).detach()
                              .requires_grad_() for a in (q, k, v))
                oh = F.scaled_dot_product_attention(qh, kh, vh)
                doh = do.view(B, Tq, H, 64).transpose(1, 2)
                nbytes = B * H * (3 * Tq + 4 * Tk) * 64 * dt.itemsize + B * H * Tq * 4
                b_ms, b_by = bound(nbytes, 5 * 2 * B * H * Tq * Tk * 64, dn)
                _, lse = EA._dense_attention_packed_cuda(q, k, v, 64, Tk, with_lse=True)
                timed[shape] = {
                    "ms": device_ms(lambda: EA._dense_attention_packed_bwd_cuda(
                        q, k, v, do, lse, 64, Tk), 8),
                    "plain_ms": device_ms(lambda: EA.dense_attention_packed_bwd_plain(
                        q, k, v, do, 64, Tk), 2),
                    "library_ms": profiled_ms(lambda: torch.autograd.grad(
                        oh, (qh, kh, vh), doh, retain_graph=True)),
                    "bound_ms": b_ms, "bound_by": b_by}
                t = timed[shape]
                print(f"  encoder_attention_bwd [{dn}] {shape}: kernel {t['ms']:.4f} ms "
                      f"(device)  plain {t['plain_ms']:.4f} ms  bound {b_ms:.4f} ms "
                      f"({b_by})  SDPA backward {t['library_ms']:.4f} ms")
                del qh, kh, vh, oh
            del q, k, v, do, lse
            torch.cuda.empty_cache()
        if dt is torch.bfloat16:
            s, c = timed["self"], timed["cross"]
            rows["encoder_attention_bwd"] = {
                "name": "encoder_attention_bwd", "route": "cuda",
                "source": SOURCES["encoder_attention_bwd"],
                "replaces": REPLACES["encoder_attention_bwd"], "launches": 0,
                "max_abs_err": worst[0], "rms_rel_err": worst[1], **s,
                **{f"cross_{k}": v for k, v in c.items()}}


def check_w8a8(rows):
    """Phase 3d: the W8A8 kernel against its plain version at the PEFT main
    path's six product shapes, bf16 and fp32, pure and with the outlier
    keep-mask and addend of the dynamic top-8 form (on inputs with a few
    large feature columns): equal bit for bit. In bf16 (the main path's)
    times, per shape, the kernel, the plain version, torch._int_mm on the
    same int8 operands (the int8 dot alone, a yardstick), and the bf16
    product with the dequantized weight (the product --no-int8_matmul
    runs); also the kernel with the outlier keep-mask and addend, and the
    whole dynamic top-8 product (`Q.int8_matmul` with no calibrated class:
    column amax, ranking, the side product, the kernel), the form the fused
    path's wide q|k|v product takes; the row's headline shape is the
    encoder's q/k/v/o. The kernel reads the weight's K-major copy, made once
    per shape outside the timing as the int8 base makes it. Each shape's
    pure product is timed before and after its profiled reading and again
    with the shapes in reverse order, torch._int_mm in both orders."""
    import torch
    from asr_finetune_tpu_torch.ops import quant as Q
    from asr_finetune_tpu_torch.ops import w8a8_fused as WF

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    shapes, timed = [], []
    for name, m, K, N in W8A8_SHAPES:
        q = Q.quantize_weight(torch.randn((K, N), generator=g, device=dev) * K ** -0.5)
        w8, ws = q["w_q8"], q["w_scale"]
        w_nk = w8.t().contiguous()      # the K-major copy the int8 base carries
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[-1]
            x = torch.randn((m, K), generator=g, device=dev)
            x[:, 5::K // 6] *= 12.0              # emergent outlier features
            x = x.to(dt)
            for form in ("pure", "outliers"):
                keep = addend = None
                if form == "outliers":
                    keep, addend = Q._outlier_split(
                        x, w8, ws, Q.QuantConfig(matmul=True, outlier_cols=8))
                out = WF.w8a8(x, w8, ws, keep, addend, w_nk)
                ref = WF.w8a8_plain(x, w8, ws, keep, addend)
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"w8a8 [{dn}] {name} {form}: {int((out != ref).sum())} elements "
                        f"differ, max abs {float((out.float() - ref.float()).abs().max()):.3e}")
            print(f"w8a8 [{dn}] {name} m {m} K {K} N {N}: kernel == plain bit for bit "
                  "(pure, outliers)")
            if dt is not torch.bfloat16:
                continue
            x32 = x.float()
            xs = torch.clamp(x32.abs().amax(-1, keepdim=True), min=1e-8) * WF.INV_127
            x8 = torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8)
            w8_cm = w8.t().contiguous().t()      # cuBLASLt's int8 layout
            w_deq = Q.dequantize_weight(q, dt)
            b_ms, b_by = bound(m * K * 2 + K * N + N * 4 + m * N * 2, 2 * m * K * N, "int8")
            dyn = Q.QuantConfig(matmul=True, outlier_cols=8)
            def pure(x=x, w8=w8, ws=ws, w_nk=w_nk):   # bound now: timed again below
                return WF.w8a8(x, w8, ws, None, None, w_nk)
            # the kernel timed before and after this shape's profiler session
            # (a torch.profiler run preceded an outlying reading), and again
            # below in the reverse order of the shapes
            t = {"shape": name, "m": m, "K": K, "N": N,
                 "ms": device_ms(pure, 16),
                 "outliers_ms": device_ms(lambda: WF.w8a8(x, w8, ws, keep, addend, w_nk), 16),
                 # the ranking writes the keep-mask from a host scalar, which a
                 # CUDA graph cannot capture: the profiler's sum over its kernels
                 "dynamic_product_ms": profiled_ms(lambda: Q.int8_matmul(x, w8, ws, dyn, w_nk)),
                 "ms_after_profile": device_ms(pure, 16),
                 "plain_ms": device_ms(lambda: WF.w8a8_plain(x, w8, ws), 2),
                 "int_mm_ms": device_ms(lambda: torch._int_mm(x8, w8_cm), 16),
                 "bf16_matmul_ms": device_ms(lambda: torch.matmul(x, w_deq), 16),
                 "bound_ms": b_ms, "bound_by": b_by}
            shapes.append(t)
            timed.append((t, pure, lambda x8=x8, w8_cm=w8_cm: torch._int_mm(x8, w8_cm)))
            print(f"  w8a8 [bfloat16] {name}: kernel {t['ms']:.4f} ms (device; "
                  f"{t['ms_after_profile']:.4f} after the profiled reading; with the outlier "
                  f"keep/addend {t['outliers_ms']:.4f} ms; the whole dynamic top-8 product, "
                  f"ranking and side product included, {t['dynamic_product_ms']:.4f} ms)  "
                  f"plain {t['plain_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
                  f"torch._int_mm {t['int_mm_ms']:.4f} ms  bf16 matmul (dequantized) "
                  f"{t['bf16_matmul_ms']:.4f} ms")
            del w_deq
        torch.cuda.empty_cache()
    for t, pure, int_mm in reversed(timed):
        t["int_mm_ms_reverse"] = device_ms(int_mm, 16)
        t["ms_reverse"] = device_ms(pure, 16)
    print("w8a8 [bfloat16] kernel ms by shape, in order / after its profiled reading / in "
          "reverse order (torch._int_mm in order / reverse): "
          + "; ".join(f"{t['shape']} {t['ms']:.4f} / {t['ms_after_profile']:.4f} / "
                      f"{t['ms_reverse']:.4f} ({t['int_mm_ms']:.4f} / {t['int_mm_ms_reverse']:.4f})"
                      for t in shapes))
    del timed
    torch.cuda.empty_cache()
    head = shapes[0]
    rows["w8a8"] = {"name": "w8a8", "route": "cuda", "source": SOURCES["w8a8"],
                    "replaces": REPLACES["w8a8"], "launches": 0, "max_abs_err": 0.0,
                    "rms_rel_err": 0.0, "ms": head["ms"], "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                    "library_ms": None, "int_mm_ms": head["int_mm_ms"],
                    "bf16_matmul_ms": head["bf16_matmul_ms"], "by_shape": shapes}


def _bwd_row(rows, name, err, fn, plain_fn, library_fn, moved, flops, dn):
    """Times a backward kernel (fn, device time by CUDA-graph replay), its
    plain version and, as a yardstick, a PyTorch backward (library_fn, by
    torch.profiler: autograd cannot be captured) and records `name`'s row."""
    b_ms, b_by = bound(moved, flops, dn)
    rows[name] = {"name": name, "route": "cuda", "source": SOURCES[name],
                  "replaces": REPLACES[name], "launches": 0, "max_abs_err": err[0],
                  "rms_rel_err": err[1], "ms": device_ms(fn, 8),
                  "plain_ms": device_ms(plain_fn, 2), "bound_ms": b_ms, "bound_by": b_by,
                  "library_ms": profiled_ms(library_fn)}
    r = rows[name]
    print(f"  {name} [{dn}] kernel {r['ms']:.4f} ms (device)  plain {r['plain_ms']:.4f} ms  "
          f"bound {b_ms:.4f} ms ({b_by})  SDPA backward {r['library_ms']:.4f} ms")


def check_attention_layouts(rows):
    """Phase 3e: the encoder-attention kernels on the two layouts of this
    slice, against their plain versions in bf16 and fp32 at whisper-large-v3
    shapes: (BH, T_p, hd) = (80, 1536, 64) with keys valid below 1500 and
    rows 1500.. zero, as ASR_TPU_DENSE_PACKED=0 pads them (dense_attention);
    and one fused (4, 1500, 3840) qkv buffer (dense_attention_qkv), whose
    backward writes one (4, 1500, 3840) gradient. Forward through the
    wrapper, backward through the autograd Function. bf16 timed beside
    F.scaled_dot_product_attention (the port never calls it) over the same
    valid keys."""
    import torch
    import torch.nn.functional as F
    from asr_finetune_tpu_torch.ops import encoder_attention as EA

    dev, BH = torch.device("cuda"), B * H
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(9)
        # (BH, T_p, hd): padded rows zero, their output rows sliced off by the caller
        q, k, v, do = (torch.randn((BH, T_PAD, 64), generator=g, device=dev).to(dt)
                       for _ in range(4))
        for t in (q, k, v, do):
            t[:, T_ENC:] = 0
        print(f"encoder_attention_bh [{dn}] ({BH}, {T_PAD}, 64) s_valid {T_ENC}:")
        out = EA.dense_attention(q, k, v, T_ENC)
        err = compare("encoder_attention_bh", out, EA.dense_attention_plain(q, k, v, T_ENC), dn)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        grads = torch.autograd.grad(EA.dense_attention(qg, kg, vg, T_ENC), (qg, kg, vg), do)
        err_b = compare("encoder_attention_bh_bwd", grads,
                        EA.dense_attention_bwd_plain(q, k, v, do, T_ENC), dn)
        if any(int(gr[:, T_ENC:].count_nonzero()) for gr in grads[1:]):
            raise AssertionError("encoder_attention_bh_bwd: padded keys got a gradient")
        del out, qg, kg, vg, grads
        if dt is torch.bfloat16:
            heads = [q[:, None], k[:, None, :T_ENC], v[:, None, :T_ENC]]
            time_row(rows, "encoder_attention_bh", err,
                     lambda: EA.dense_attention(q, k, v, T_ENC),
                     lambda: EA.dense_attention_plain(q, k, v, T_ENC),
                     BH * (2 * T_PAD + 2 * T_ENC) * 64 * dt.itemsize,
                     4 * BH * T_PAD * T_ENC * 64, dn,
                     library_fn=lambda: F.scaled_dot_product_attention(*heads), calls=8)
            _, lse = EA._dense_attention_packed_cuda(q, k, v, 64, T_ENC, with_lse=True,
                                                     name=EA.BH)
            hg = [t.detach().requires_grad_() for t in heads]
            oh = F.scaled_dot_product_attention(*hg)
            _bwd_row(rows, "encoder_attention_bh_bwd", err_b,
                     lambda: EA._dense_attention_packed_bwd_cuda(q, k, v, do, lse, 64, T_ENC,
                                                                 name=EA.BH),
                     lambda: EA.dense_attention_bwd_plain(q, k, v, do, T_ENC),
                     lambda: torch.autograd.grad(oh, hg, do[:, None], retain_graph=True),
                     BH * (3 * T_PAD + 4 * T_ENC) * 64 * dt.itemsize + BH * T_PAD * 4,
                     5 * 2 * BH * T_PAD * T_ENC * 64, dn)
            del lse, hg, oh
        del q, k, v, do
        torch.cuda.empty_cache()

        qkv = torch.randn((B, T_ENC, 3 * D), generator=g, device=dev).to(dt)
        do = torch.randn((B, T_ENC, D), generator=g, device=dev).to(dt)
        print(f"encoder_attention_qkv [{dn}] qkv ({B}, {T_ENC}, {3 * D}):")
        out = EA.dense_attention_qkv(qkv, 64)
        err = compare("encoder_attention_qkv", out, EA.dense_attention_qkv_plain(qkv, 64), dn)
        xg = qkv.detach().requires_grad_()
        (grad,) = torch.autograd.grad(EA.dense_attention_qkv(xg, 64), (xg,), do)
        if grad.shape != qkv.shape or not grad.is_contiguous():
            raise AssertionError(f"qkv gradient {tuple(grad.shape)}, not one (B, T, 3D) buffer")
        err_b = compare("encoder_attention_qkv_bwd", grad,
                        EA.dense_attention_qkv_bwd_plain(qkv, do, 64), dn)
        del out, xg, grad
        if dt is torch.bfloat16:
            heads = [t.view(B, T_ENC, H, 64).transpose(1, 2) for t in EA._qkv_views(qkv, 64)]
            time_row(rows, "encoder_attention_qkv", err,
                     lambda: EA.dense_attention_qkv(qkv, 64),
                     lambda: EA.dense_attention_qkv_plain(qkv, 64),
                     4 * B * T_ENC * D * dt.itemsize, 4 * B * H * T_ENC * T_ENC * 64, dn,
                     library_fn=lambda: F.scaled_dot_product_attention(*heads), calls=8)
            views = EA._qkv_views(qkv, 64)
            _, lse = EA._dense_attention_packed_cuda(*views, 64, T_ENC, with_lse=True,
                                                     name=EA.QKV)
            dqkv = torch.empty_like(qkv)
            hg = [t.detach().requires_grad_() for t in heads]
            oh = F.scaled_dot_product_attention(*hg)
            doh = do.view(B, T_ENC, H, 64).transpose(1, 2)
            _bwd_row(rows, "encoder_attention_qkv_bwd", err_b,
                     lambda: EA._dense_attention_packed_bwd_cuda(
                         *views, do, lse, 64, T_ENC, name=EA.QKV,
                         out=EA._qkv_views(dqkv, 64)),
                     lambda: EA.dense_attention_qkv_bwd_plain(qkv, do, 64),
                     lambda: torch.autograd.grad(oh, hg, doh, retain_graph=True),
                     B * H * 7 * T_ENC * 64 * dt.itemsize + B * H * T_ENC * 4,
                     5 * 2 * B * H * T_ENC * T_ENC * 64, dn)
            del lse, dqkv, hg, oh
        del qkv, do
        torch.cuda.empty_cache()


def check_log_mel(rows):
    """Phase 3f: the log-mel kernel (fp32 on the CUDA cores, no TF32) against
    its plain version at B 4 over 30 s of seeded noise (one utterance part
    silence), 80 and 128 mel bins, normalized output within the fp32 limits;
    timed at 128 (large-v3's) beside the production conv form
    ops/logmel.log_mel_spectrogram as the yardstick (not one PyTorch call:
    the frames' product and the mel product)."""
    import torch
    from asr_finetune_tpu_torch.ops import logmel as LM
    from asr_finetune_tpu_torch.ops import logmel_fused as LF

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    audio = torch.randn((B, LM.CHUNK_SAMPLES), generator=g, device=dev) * 0.1
    audio[B - 1, 100_000:300_000] = 0.0
    for n_mels in (80, 128):
        print(f"log_mel [float32] B {B}, {n_mels} mel bins:")
        out = LF.log_mel_fused(audio, n_mels)
        if out.shape != (B, LM.NUM_FRAMES, n_mels):
            raise AssertionError(f"log_mel output {tuple(out.shape)}")
        err = compare("log_mel", out, LF.log_mel_fused_plain(audio, n_mels), "float32")
        if n_mels == 128:
            # the plain version and the conv form upload their DFT and mel
            # tables at every call, which a CUDA graph cannot capture: their
            # device time is the profiler's sum over their kernels and copies
            b_ms, b_by = bound(nbytes(audio, out),
                               B * LM.NUM_FRAMES * (400 * 402 * 2 + 201 * n_mels * 2),
                               "float32")
            r = rows["log_mel"] = {
                "name": "log_mel", "route": "cuda", "source": SOURCES["log_mel"],
                "replaces": REPLACES["log_mel"], "launches": 0, "max_abs_err": err[0],
                "rms_rel_err": err[1],
                "ms": device_ms(lambda: LF.log_mel_fused(audio, n_mels), 16),
                "raw_ms": device_ms(lambda: LF._log10_mel_cuda(audio, n_mels), 16),
                "plain_ms": profiled_ms(lambda: LF.log_mel_fused_plain(audio, n_mels)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": profiled_ms(lambda: LM.log_mel_spectrogram(audio, n_mels))}
            print(f"  log_mel [float32] {n_mels} mels: function {r['ms']:.4f} ms (device; the "
                  f"kernel alone {r['raw_ms']:.4f} ms)  plain {r['plain_ms']:.4f} ms  bound "
                  f"{b_ms:.4f} ms ({b_by})  conv form {r['library_ms']:.4f} ms")
    del audio
    torch.cuda.empty_cache()


def check_decode():
    """Phase 4: fp32 greedy decode at large-v3 width, 2+2 layers, B=2, 24
    tokens: the fused kernels and the plain decode step give equal tokens."""
    import torch
    from asr_finetune_tpu_torch.evaluation import decode as D_
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.models.configs import get_config

    cfg = dataclasses.replace(get_config("large-v3"), encoder_layers=2,
                              decoder_layers=2)
    dev = torch.device("cuda")
    params = W.init_params(cfg, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    mel = torch.randn((2, 3000, cfg.num_mel_bins), generator=g, device=dev)
    forced = [cfg.sot_token_id, cfg.first_language_token_id,
              cfg.transcribe_token_id, cfg.no_timestamps_token_id]
    kw = dict(max_length=24, compute_dtype=torch.float32)
    t_fused, l_fused = D_.greedy_decode(params, mel, cfg, forced, fused=True, **kw)
    t_plain, l_plain = D_.greedy_decode(params, mel, cfg, forced, fused=False, **kw)
    if not (torch.equal(t_fused, t_plain) and torch.equal(l_fused, l_plain)):
        raise AssertionError(f"fused decode tokens {t_fused.tolist()} != plain "
                             f"{t_plain.tolist()}")
    print(f"fp32 greedy decode, large-v3 width, 2+2 layers: fused == plain "
          f"({t_fused.shape[1]} tokens x {t_fused.shape[0]} rows)")


def check_beam_decode(device: str = "cuda", model: str = "large-v3"):
    """Phase 4e: fp32 beam-4 decode at large-v3 width, 2+2 layers, B=2, 24
    tokens: the fused kernels (ancestry-masked beam self-attention, the
    cross K/V shared per utterance) and the plain decode step (cache
    reordered each step) give equal tokens and lengths, over float and over
    int8 cross K/V; the fused kernels with the cache reordered
    (ASR_TPU_BEAM_REORDER=1) equal the ancestry path; and the same fused ==
    plain at WIDE_BEAMS, beyond the Pallas kernels' 8. `device` and `model`
    let it run a small model on the CPU (both sides plain there)."""
    import torch
    from asr_finetune_tpu_torch.evaluation import decode as D_
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.models.configs import get_config

    cfg = dataclasses.replace(get_config(model), encoder_layers=2, decoder_layers=2)
    dev = torch.device(device)
    params = W.init_params(cfg, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    mel = torch.randn((2, 2 * cfg.max_source_positions, cfg.num_mel_bins), generator=g,
                      device=dev)
    forced = [cfg.sot_token_id, cfg.first_language_token_id,
              cfg.transcribe_token_id, cfg.no_timestamps_token_id]
    kw = dict(max_length=24, num_beams=BEAMS, compute_dtype=torch.float32)
    out = {}
    for kv8 in (False, True):
        reset_all_launches()
        out[kv8] = D_.beam_decode(params, mel, cfg, forced, fused=True, kv_int8=kv8, **kw)
        n = all_launches()
        plain = D_.beam_decode(params, mel, cfg, forced, fused=False, kv_int8=kv8, **kw)
        if not all(torch.equal(a, b) for a, b in zip(out[kv8], plain)):
            raise AssertionError(f"beam decode (kv_int8={kv8}): fused {out[kv8]} != plain "
                                 f"{plain}")
        path = BEAM_KV8_DECODER if kv8 else BEAM_DECODER
        if device == "cuda" and not all(n[k] > 0 for k in path):
            raise AssertionError(f"the fused beam decode did not run {path}: {n}")
    os.environ["ASR_TPU_BEAM_REORDER"] = "1"
    try:
        reordered = D_.beam_decode(params, mel, cfg, forced, fused=True, **kw)
    finally:
        del os.environ["ASR_TPU_BEAM_REORDER"]
    if not all(torch.equal(a, b) for a, b in zip(out[False], reordered)):
        raise AssertionError(f"beam decode: reorder {reordered} != ancestry {out[False]}")
    kw["num_beams"] = WIDE_BEAMS
    reset_all_launches()
    wide = D_.beam_decode(params, mel, cfg, forced, **kw)   # fused by default on the card
    n = all_launches()
    plain = D_.beam_decode(params, mel, cfg, forced, fused=False, **kw)
    if not all(torch.equal(a, b) for a, b in zip(wide, plain)):
        raise AssertionError(f"beam-{WIDE_BEAMS} decode: fused {wide} != plain {plain}")
    if device == "cuda" and not all(n[k] > 0 for k in BEAM_DECODER):
        raise AssertionError(f"the beam-{WIDE_BEAMS} decode did not run {BEAM_DECODER}: {n}")
    print(f"fp32 beam-{BEAMS} decode, {model} width, 2+2 layers: fused == plain, float and "
          f"int8 cross K/V; reorder == ancestry (lengths {out[False][1].tolist()}, "
          f"int8 K/V {out[True][1].tolist()}); beam-{WIDE_BEAMS} fused == plain")


def _write_wav(path, seconds, rng, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    sig = sum(np.sin(2 * np.pi * f * t) * a
              for f, a in zip(rng.uniform(80, 2000, 3), rng.uniform(0.05, 0.3, 3)))
    sig = sig + rng.standard_normal(t.shape) * 0.01
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())


def main_path(rows, beams: int = 1, kv_int8: bool = False, reorder: bool = False,
              fused_qkv: bool = False):
    """Phase 5: transcribe four wavs with whisper-large-v3 through the CLI,
    greedy or with --generation_num_beams `beams` (--decode_kv_int8 with
    kv_int8; the whole cache reordered each step, ASR_TPU_BEAM_REORDER=1,
    with reorder; the encoder on the fused-qkv path, ASR_TPU_FUSED_QKV=1,
    with fused_qkv). Asserts the transcripts, the forced prefix, every
    kernel's launch count against the count the path implies and, for
    beams, the cross K/V held at the utterances' B rows while the decode
    runs B x beams hypothesis rows."""
    import torch
    from asr_finetune_tpu_torch.cli import transcribe
    from asr_finetune_tpu_torch.evaluation import decode as decode_lib
    from asr_finetune_tpu_torch.models import whisper as W

    max_len = 64
    path = "transcribe" + (f"_beam{beams}" if beams > 1 else "") + ("_kv8" if kv_int8 else "") \
        + ("_reorder" if reorder else "") + ("_fused_qkv" if fused_qkv else "")
    env = {"ASR_TPU_BEAM_REORDER": "1"} if reorder else {}
    if fused_qkv:
        env["ASR_TPU_FUSED_QKV"] = "1"
    stats = {"encode": 0, "steps": 0, "decode_s": 0.0, "loop_s": 0.0,
             "tokens": [], "cross_rows": set(), "token_rows": set()}
    decode_name = "greedy_decode" if beams == 1 else "beam_decode"
    orig_encode, orig_step, orig_decode = (W.encode, W.decode_step_fused,
                                           getattr(decode_lib, decode_name))

    def encode(*a, **k):
        stats["encode"] += 1
        return orig_encode(*a, **k)

    def step(*a, **k):
        if stats["steps"] == 0 or a[2] == 0:
            torch.cuda.synchronize()
            stats["loop_t0"] = time.perf_counter()
        stats["steps"] += 1
        cross = a[4]
        stats["cross_rows"].add(int(cross["k_q8" if "k_q8" in cross else "k"].shape[1]))
        stats["token_rows"].add(int(a[1].shape[0]))
        return orig_step(*a, **k)

    def decode(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_decode(*a, **k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stats["decode_s"] += t1 - t0
        stats["loop_s"] += t1 - stats["loop_t0"]
        stats["tokens"].append(out[0].cpu())
        return out

    extra = (["--generation_num_beams", str(beams)] if beams > 1 else []) \
        + (["--decode_kv_int8"] if kv_int8 else [])
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        wavs = []
        for i, sec in enumerate((4.0, 9.5, 31.5, 17.0)):   # one > 30 s: 2 windows
            p = f"{tmp}/utt{i}.wav"
            _write_wav(p, sec, rng)
            wavs.append(p)
        W.encode, W.decode_step_fused = encode, step
        setattr(decode_lib, decode_name, decode)
        os.environ.update(env)
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            results = transcribe.main([
                "--inputs", *wavs, "--output", f"{tmp}/out.jsonl",
                "--model_type", "large-v3", "--bf16",
                "--per_device_eval_batch_size", str(B),
                "--generation_max_length", str(max_len), "--device", "cuda", *extra])
        finally:
            W.encode, W.decode_step_fused = orig_encode, orig_step
            setattr(decode_lib, decode_name, orig_decode)
            for k in env:
                os.environ.pop(k, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        peak = torch.cuda.max_memory_allocated()
        lines = open(f"{tmp}/out.jsonl").read().splitlines()

    if len(results) != 4 or [r["file"] for r in results] != wavs or len(lines) != 4:
        raise AssertionError(f"expected 4 transcripts in input order, got {results}")
    if not all(isinstance(r["text"], str) for r in results):
        raise AssertionError("non-text transcript")
    # 5 windows in batches of 4 → 2 encoder batches
    if stats["encode"] != 2:
        raise AssertionError(f"expected 2 encoder batches, ran {stats['encode']}")
    for tok in stats["tokens"]:
        if tok.shape != (B, max_len) or int(tok.min()) < 0 or int(tok.max()) >= 51866:
            raise AssertionError(f"bad token matrix {tuple(tok.shape)}")
        if tok[:, :4].tolist() != [[257, 258, 261, 262]] * B:   # byte-fallback prefix
            raise AssertionError(f"forced prefix not honoured: {tok[:, :4].tolist()}")
    if stats["cross_rows"] != {B} or stats["token_rows"] != {B * beams}:
        raise AssertionError(f"decode rows {stats['token_rows']} over cross K/V rows "
                             f"{stats['cross_rows']}: expected {B * beams} over {B}")
    n_dec = 32
    kernels = (DECODER if beams == 1 else REORDER_DECODER if reorder
               else BEAM_KV8_DECODER if kv_int8 else BEAM_DECODER)
    enc_kernel = "encoder_attention_qkv" if fused_qkv else "encoder_attention"
    expect = expect_launches(**{enc_kernel: n_dec * stats["encode"]},
                             **{k: n_dec * stats["steps"] for k in kernels})
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    record_launches(rows, path, launches)
    label = f"main path {path}"
    n_utt = 4
    print(f"{label}: whisper-large-v3 (32+32 layers, bf16, random init), "
          f"4 wavs / 5 windows / {stats['encode']} batches of {B}"
          + (f" x {beams} beams ({B * beams} hypothesis rows over cross K/V of {B})"
             if beams > 1 else "") + f", {stats['steps']} decode steps")
    print(f"{label}: wall {wall:.3f} s incl. model init; encode+decode "
          f"{stats['decode_s']:.3f} s; {n_utt / stats['decode_s']:.3f} utterances/s "
          f"(encode+decode); {1e3 * stats['loop_s'] / stats['steps']:.3f} ms/step "
          f"(token loop, {B * beams} rows); peak memory {peak / 2**30:.2f} GiB")
    print(f"{label}: launches {json.dumps({k: v for k, v in launches.items() if v})}")
    for r in results:
        print(f"  {r['file'].rsplit('/', 1)[-1]}: {len(r['text'])} chars")


def evaluator_path(rows):
    """Phase 5b: the offline evaluator (evaluation/evaluate.OfflineEvaluator,
    what cli.evaluate drives over an HDF5 test set) with beam-4 decoding of
    whisper-large-v3 (32+32 layers, bf16, random init) over four seeded wavs
    with German-looking references, in two batches of 2, checkpointing
    progress every batch: a first run stops after batch 1, a second resumes
    at batch 2. Asserts the progress files, eval_final.json (4 transcripts,
    a finite WER) and that the resumed run decoded only the second batch."""
    import torch
    from asr_finetune_tpu_torch import config as config_lib
    from asr_finetune_tpu_torch import run as run_lib
    from asr_finetune_tpu_torch.data.audiofolder import read_wav
    from asr_finetune_tpu_torch.data.collator import Collator, CollatorConfig
    from asr_finetune_tpu_torch.evaluation.evaluate import EvalConfig, OfflineEvaluator

    built = run_lib.build_model(config_lib.parse_args(
        ["--model_type", "large-v3", "--bf16", "--device", "cuda"]))
    col = Collator(built.tokenizer, CollatorConfig(n_mels=built.cfg.num_mel_bins))
    with tempfile.TemporaryDirectory() as tmp:
        write_audiofolder(tmp, 4, seed=1)
        import csv
        with open(f"{tmp}/metadata.csv", encoding="utf-8") as f:
            meta = list(csv.DictReader(f))
        utts = [(i, read_wav(f"{tmp}/{m['file_name']}"), m["transcription"])
                for i, m in enumerate(meta)]
        batches = [col(utts[:2]), col(utts[2:])]
        cfg = EvalConfig(language="german", max_length=48, num_beams=BEAMS, batch_size=2,
                         checkpoint_every=1, output_dir=f"{tmp}/eval",
                         compute_dtype=torch.bfloat16)
        reset_all_launches()
        t0 = time.perf_counter()
        OfflineEvaluator(built.cfg, built.params, built.tokenizer, cfg).run(batches[:1])
        first = all_launches()
        reset_all_launches()
        final = OfflineEvaluator(built.cfg, built.params, built.tokenizer, cfg).run(batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        second = all_launches()
        files = sorted(os.listdir(f"{tmp}/eval"))
        with open(f"{tmp}/eval/eval_final.json", encoding="utf-8") as f:
            on_disk = json.load(f)
    del built
    torch.cuda.empty_cache()
    want_files = ["eval_checkpoint.json", "eval_final.json", "eval_step_1.json",
                  "eval_step_2.json"]
    if files != want_files or on_disk["results"] != final["results"]:
        raise AssertionError(f"evaluator files {files} (expected {want_files})")
    if final["n_utterances"] != 4 or not np.isfinite(final["wer"]) or not all(
            {"original", "predicted", "wer"} <= set(r) for r in final["results"]):
        raise AssertionError(f"evaluator result {final}")
    # each run encoded one batch (32 encoder layers) and ran the beam path
    for n in (first, second):
        if n["encoder_attention"] != 32 or len({n[k] for k in BEAM_DECODER}) != 1 \
                or n["fused_qkv"] == 0:
            raise AssertionError(f"evaluator launches {n}")
    launches = {k: first[k] + second[k] for k in first}
    record_launches(rows, f"evaluate_beam{BEAMS}", launches)
    print(f"offline evaluator, beam-{BEAMS}, large-v3 32+32 bf16: 4 utterances in 2 batches "
          f"(run stopped after batch 1, resumed at batch 2), corpus WER {final['wer']:.2f}%, "
          f"{wall:.3f} s for both runs; launches {json.dumps({k: v for k, v in launches.items() if v})}")


def record_launches(rows, path: str, launches) -> None:
    """Adds one main path's launch counts to the kernels' rows: "launches" is
    the sum over the paths, "launches_by_path" each path's own count."""
    for k, n in launches.items():
        by_path = rows[k].setdefault("launches_by_path", {})
        by_path[path] = n
        rows[k]["launches"] = sum(by_path.values())


def check_train_grads(device: str = "cuda", model: str = "large-v3"):
    """Phase 4b: one full-fine-tuning step's gradients at whisper-large-v3
    width (d 1280, 20 heads, ff 5120, vocab 51866), 2+2 layers, fp32, batch
    2, labels at the 192 bucket: through the attention kernels (attn_impl
    "auto": forward with lse, backward kernel) against plain attention
    under autograd (attn_impl "xla", and the cross-attention, which the
    decoder promotes to "auto", held plain as well); and with remat on
    against off, within GRAD_LIMITS. `device` and `model` let the same
    function run a small model on the CPU."""
    import torch
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.models.configs import get_config
    from asr_finetune_tpu_torch.ops import attention as A
    from asr_finetune_tpu_torch.ops import encoder_attention as EA
    from asr_finetune_tpu_torch.training import optim
    from asr_finetune_tpu_torch.training import train_step as TS

    cfg = dataclasses.replace(get_config(model), encoder_layers=2, decoder_layers=2)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(5)
    bsz = 2
    tokens = torch.randint(0, cfg.eos_token_id, (bsz, CROSS_TQ), generator=g, device=dev)
    labels = torch.cat([tokens[:, 1:], torch.full((bsz, 1), cfg.eos_token_id,
                                                  device=dev)], 1)
    labels[0, 120:] = -100                      # a padded row, as the collator pads
    batch = {"mel": torch.randn((bsz, 3000, cfg.num_mel_bins), generator=g, device=dev),
             "decoder_input_ids": tokens, "labels": labels}

    def grads(**kw):
        params = W.init_params(cfg, seed=6, device=dev)
        TS.make_train_state(params, optim.make_optimizer(1e-5, 10))
        EA.reset_launches()
        gs, m = TS.compute_grads(params, batch, cfg, TS.TrainStepConfig(
            compute_dtype=torch.float32, **kw))
        return ([x.detach().clone() for x in gs], float(m["loss"]),
                {k: v for k, v in EA.LAUNCHES.items() if v})

    def worst(a, b):
        return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for x, y in zip(a, b))

    g_k, loss_k, n_k = grads(remat=False)
    g_r, loss_r, n_r = grads(remat=True)
    orig = A.encoder_attention
    A.encoder_attention = lambda q, k, v: A.xla_attention(q, k, v)
    try:
        g_p, loss_p, n_p = grads(remat=False, attn_impl="xla")
    finally:
        A.encoder_attention = orig
    # 2 encoder self-attentions + 2 cross-attentions; remat runs the forward again
    want = ({"encoder_attention": 4, "encoder_attention_bwd": 4},
            {"encoder_attention": 8, "encoder_attention_bwd": 4},
            {})
    if (n_k, n_r, n_p) != want:
        raise AssertionError(f"gradient check launches {(n_k, n_r, n_p)} != {want}")
    readings = {"kernels vs plain": worst(g_k, g_p), "remat vs not": worst(g_r, g_k)}
    print(f"train-step gradients, {model} width, 2+2 layers, fp32: loss kernels "
          f"{loss_k:.7f} plain {loss_p:.7f} remat {loss_r:.7f}; max |diff| / max |grad| "
          f"over the {len(g_k)} leaves: "
          + ", ".join(f"{k} {v:.3e} (limit {GRAD_LIMITS[k]})" for k, v in readings.items()))
    if not all(map(np.isfinite, (loss_k, loss_r, loss_p))) \
            or abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or loss_r != loss_k \
            or any(v > GRAD_LIMITS[k] for k, v in readings.items()):
        raise AssertionError("train-step gradients through the kernels differ")


def check_int8_decode():
    """Phase 4c: fp32 greedy decode at large-v3 width, 2+2 layers, B=2, 24
    tokens, over a merged int8 base (AdaLoRA rank-8 adapters with non-zero
    deltas folded into q/v, the rest int8): the fused kernels with their
    int8-weight options and the plain decode step give equal tokens."""
    import torch
    from asr_finetune_tpu_torch.evaluation import decode as D_
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.models.configs import get_config
    from asr_finetune_tpu_torch.ops import quant as Q
    from asr_finetune_tpu_torch.training import lora as LO

    cfg = dataclasses.replace(get_config("large-v3"), encoder_layers=2, decoder_layers=2)
    dev = torch.device("cuda")
    adapters = _peft_adapters(cfg, dev)
    merged = LO.merge_adapters(Q.quantize_tree_int8(W.init_params(cfg, seed=1, device=dev)),
                               adapters)
    g = torch.Generator(device=dev).manual_seed(2)
    mel = torch.randn((2, 3000, cfg.num_mel_bins), generator=g, device=dev)
    forced = [cfg.sot_token_id, cfg.first_language_token_id,
              cfg.transcribe_token_id, cfg.no_timestamps_token_id]
    kw = dict(max_length=24, compute_dtype=torch.float32)
    reset_all_launches()
    t_fused, l_fused = D_.greedy_decode(merged, mel, cfg, forced, fused=True, **kw)
    n = all_launches()
    t_plain, l_plain = D_.greedy_decode(merged, mel, cfg, forced, fused=False, **kw)
    if not (torch.equal(t_fused, t_plain) and torch.equal(l_fused, l_plain)):
        raise AssertionError(f"int8 fused decode tokens {t_fused.tolist()} != plain "
                             f"{t_plain.tolist()}")
    if not all(n[k + "_int8"] > 0 and n[k] == 0 for k in DECODER):
        raise AssertionError(f"the int8 decode did not run the int8 kernels: {n}")
    print(f"fp32 greedy decode, large-v3 width, 2+2 layers, merged int8 base: fused "
          f"(int8 weights) == plain ({t_fused.shape[1]} tokens x {t_fused.shape[0]} rows)")


def _peft_adapters(cfg, dev, seed: int = 8):
    """AdaLoRA rank-8 adapters on every q/v with b drawn N(0, 0.02), so the
    deltas and every gradient are live."""
    import torch
    from asr_finetune_tpu_torch.training import lora as LO
    g = torch.Generator(device=dev).manual_seed(seed)
    ad = LO.init_adapters(g, cfg, LO.LoraConfig(rank=8, alpha=16.0, adalora=True),
                          encoder=True, device=dev)
    for _, stack in LO._adapter_stacks(ad):
        stack["b"].normal_(generator=g).mul_(0.02)
    return ad


def check_peft_grads(device: str = "cuda", model: str = "large-v3"):
    """Phase 4d: one fp32 PEFT step's adapter gradients at whisper-large-v3
    width, 2+2 layers, batch 2, labels at the 192 bucket, over the int8 base,
    within PEFT_GRAD_LIMITS: with W8A8 (8 dynamic outlier columns) through
    every kernel against the W8A8 plain version alone swapped in; and over
    the base dequantized (no int8 rounding of activations) through the
    attention kernels, forward and backward, against plain attention."""
    import torch
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.models.configs import get_config
    from asr_finetune_tpu_torch.ops import attention as A
    from asr_finetune_tpu_torch.ops import quant as Q
    from asr_finetune_tpu_torch.ops import w8a8_fused as WF
    from asr_finetune_tpu_torch.training import lora as LO
    from asr_finetune_tpu_torch.training import optim
    from asr_finetune_tpu_torch.training import train_step as TS

    cfg = dataclasses.replace(get_config(model), encoder_layers=2, decoder_layers=2)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(5)
    bsz = 2
    tokens = torch.randint(0, cfg.eos_token_id, (bsz, CROSS_TQ), generator=g, device=dev)
    labels = torch.cat([tokens[:, 1:], torch.full((bsz, 1), cfg.eos_token_id,
                                                  device=dev)], 1)
    labels[0, 120:] = -100
    batch = {"mel": torch.randn((bsz, 3000, cfg.num_mel_bins), generator=g, device=dev),
             "decoder_input_ids": tokens, "labels": labels}
    params = Q.add_k_major_copies(Q.quantize_tree_int8(W.init_params(cfg, seed=6, device=dev)))
    lcfg = LO.LoraConfig(rank=8, alpha=16.0, dropout=0.0, adalora=True)

    def grads(w8a8: bool, **kw):
        adapters = _peft_adapters(cfg, dev)
        TS.make_train_state(params, optim.make_optimizer(1e-5, 10), adapters)
        reset_all_launches()
        gs, m = TS.compute_grads(params, batch, cfg, TS.TrainStepConfig(
            mode="peft", compute_dtype=torch.float32, remat=False, lora=lcfg,
            quant=Q.QuantConfig(matmul=w8a8, outlier_cols=8), **kw), adapters)
        n = all_launches()
        return [x.detach().clone() for x in gs], float(m["loss"]), n

    def worst(a, b):
        return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for x, y in zip(a, b))

    g_k, loss_k, n_k = grads(True)
    g_d, loss_d, n_d = grads(False)
    orig_w8a8, orig_attn = Q.w8a8, A.encoder_attention
    Q.w8a8 = lambda x, w, sc, keep=None, addend=None, w_nk=None: WF.w8a8_plain(
        x, w, sc, keep, addend)
    try:
        g_w, loss_w, n_w = grads(True)
        A.encoder_attention = lambda q, k, v: A.xla_attention(q, k, v)
        g_p, loss_p, n_p = grads(False, attn_impl="xla")
    finally:
        Q.w8a8, A.encoder_attention = orig_w8a8, orig_attn
    n_mm = 6 * cfg.encoder_layers + 10 * cfg.decoder_layers
    attn = dict(encoder_attention=4, encoder_attention_bwd=4)
    want = (expect_launches(w8a8=n_mm, **attn), expect_launches(**attn),
            expect_launches(**attn), expect_launches())
    if (n_k, n_d, n_w, n_p) != want:
        raise AssertionError(f"PEFT gradient check launches {(n_k, n_d, n_w, n_p)} != {want}")
    readings = {"w8a8 kernel vs plain": worst(g_k, g_w),
                "attention kernels vs plain": worst(g_d, g_p)}
    print(f"PEFT step adapter gradients, {model} width, 2+2 layers, int8 base, fp32: loss "
          f"W8A8 kernel {loss_k:.7f} W8A8 plain {loss_w:.7f}, dequantized base attention "
          f"kernels {loss_d:.7f} plain {loss_p:.7f}; max |diff| / max |grad| over the "
          f"{len(g_k)} adapter leaves: "
          + ", ".join(f"{k} {v:.3e} (limit {PEFT_GRAD_LIMITS[k]})" for k, v in readings.items()))
    if not all(map(np.isfinite, (loss_k, loss_w, loss_d, loss_p))) or loss_w != loss_k \
            or abs(loss_d - loss_p) > 1e-5 * abs(loss_p) \
            or any(v > PEFT_GRAD_LIMITS[k] for k, v in readings.items()):
        raise AssertionError("PEFT-step gradients through the kernels differ")


def check_layout_paths(device: str = "cuda", model: str = "large-v3"):
    """Phase 4f: at whisper-large-v3 width, 2+2 layers, fp32, batch 2, labels
    at the 192 bucket: the fused-qkv encoder path (ASR_TPU_FUSED_QKV=1:
    one wide q|k|v product into the fused-qkv attention kernel) against the
    three projections, and the (BH, T, hd) layout (ASR_TPU_DENSE_PACKED=0)
    against the packed one, on (a) the encoder output, (b) a full
    fine-tuning step's gradients on every leaf (remat on) and (c) a PEFT
    step's adapter gradients over the int8 base dequantized (AdaLoRA rank 8,
    lora dropout 0.1: the fused path must draw the unfused masks), each the
    largest max |diff| / max |ref| over the outputs or leaves, within
    LAYOUT_LIMITS; asserts the kernels each variant runs. `device` and
    `model` let it run a small model on the CPU."""
    import torch
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.models.configs import get_config
    from asr_finetune_tpu_torch.ops import quant as Q
    from asr_finetune_tpu_torch.training import lora as LO
    from asr_finetune_tpu_torch.training import optim
    from asr_finetune_tpu_torch.training import train_step as TS

    cfg = dataclasses.replace(get_config(model), encoder_layers=2, decoder_layers=2)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(11)
    bsz = 2
    tokens = torch.randint(0, cfg.eos_token_id, (bsz, CROSS_TQ), generator=g, device=dev)
    labels = torch.cat([tokens[:, 1:], torch.full((bsz, 1), cfg.eos_token_id,
                                                  device=dev)], 1)
    labels[0, 120:] = -100
    mel = torch.randn((bsz, 2 * cfg.max_source_positions, cfg.num_mel_bins), generator=g,
                      device=dev)
    batch = {"mel": mel, "decoder_input_ids": tokens, "labels": labels}
    base_q = Q.quantize_tree_int8(W.init_params(cfg, seed=6, device=dev))
    lcfg = LO.LoraConfig(rank=8, alpha=16.0, dropout=0.1, adalora=True)

    def run(env):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            reset_all_launches()
            params = W.init_params(cfg, seed=6, device=dev)
            with torch.no_grad():
                enc = W.encode(params, mel, cfg, torch.float32)
            TS.make_train_state(params, optim.make_optimizer(1e-5, 10))
            full, _ = TS.compute_grads(params, batch, cfg, TS.TrainStepConfig(
                compute_dtype=torch.float32, remat=True))
            adapters = _peft_adapters(cfg, dev)
            TS.make_train_state(base_q, optim.make_optimizer(1e-5, 10), adapters)
            peft, _ = TS.compute_grads(base_q, batch, cfg, TS.TrainStepConfig(
                mode="peft", compute_dtype=torch.float32, remat=False, lora=lcfg,
                quant=Q.QuantConfig(matmul=False)), adapters, step=3)
            return ({"encoder output": [enc], "full-FT gradients": [x.detach().clone() for x in full],
                     "PEFT adapter gradients": [x.detach().clone() for x in peft]},
                    all_launches())
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def worst(a, b):
        return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for x, y in zip(a, b))

    ref, n_ref = run({"ASR_TPU_FUSED_QKV": "0", "ASR_TPU_DENSE_PACKED": "1"})
    n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
    # the encode, then per step the forward twice (remat) in full FT, once in
    # PEFT, and one backward each
    want = {"fused-qkv": dict(encoder_attention_qkv=n_enc * 4,
                              encoder_attention_qkv_bwd=n_enc * 2,
                              encoder_attention=n_dec * 3, encoder_attention_bwd=n_dec * 2),
            "(BH, T, hd)": dict(encoder_attention_bh=n_enc * 4 + n_dec * 3,
                                encoder_attention_bh_bwd=(n_enc + n_dec) * 2)}
    if device == "cuda" and {k: v for k, v in n_ref.items() if v} != dict(
            encoder_attention=(n_enc + n_dec) * 3 + n_enc, encoder_attention_bwd=(n_enc + n_dec) * 2):
        raise AssertionError(f"packed reference launches {n_ref}")
    for name, env in (("fused-qkv", {"ASR_TPU_FUSED_QKV": "1", "ASR_TPU_DENSE_PACKED": "1"}),
                      ("(BH, T, hd)", {"ASR_TPU_FUSED_QKV": "0", "ASR_TPU_DENSE_PACKED": "0"})):
        got, n = run(env)
        if device == "cuda" and {k: v for k, v in n.items() if v} != want[name]:
            raise AssertionError(f"{name}: launches {n} != {want[name]}")
        readings = {k: worst(got[k], ref[k]) for k in ref}
        print(f"{name} vs packed three-projection path, {model} width, 2+2 layers, fp32: "
              + ", ".join(f"{k} {v:.3e} (limit {LAYOUT_LIMITS[k]})" for k, v in readings.items()))
        if not all(np.isfinite(v) and v <= LAYOUT_LIMITS[k] for k, v in readings.items()):
            raise AssertionError(f"{name}: differs from the packed three-projection path")


GERMAN_WORDS = ("und", "der", "die", "wir", "haben", "damals", "Großmutter", "Krieg",
                "Schule", "über", "Flüchtlinge", "Erinnerung", "Dorf", "Vater",
                "Mutter", "wurde", "nach", "Hause", "gekommen", "Jahre", "später",
                "Arbeit", "Fabrik", "mussten", "zurück", "Straße", "Kinder",
                "gespielt", "Nachbarn", "erzählt", "ich", "weiß", "nicht", "mehr",
                "genau", "wann", "ähnlich", "schön", "Brücke", "Bahnhof")


def write_audiofolder(folder, n: int, seed: int = 0) -> None:
    """n seeded wavs of 3-28 s and German-looking transcripts of 100-150
    characters (byte-fallback labels of 104-170 tokens: the 192 bucket) as
    an HF audiofolder: the wavs plus metadata.csv."""
    import csv
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        name = f"utt{i:03d}.wav"
        _write_wav(f"{folder}/{name}", rng.uniform(3.0, 28.0), rng)
        want = int(rng.integers(100, 151))
        words = []
        while len(" ".join(words)) < want:
            words.append(GERMAN_WORDS[int(rng.integers(len(GERMAN_WORDS)))])
        text = " ".join(words)[:want - 1].rstrip() + "."
        rows.append((name, text[0].upper() + text[1:]))
    with open(f"{folder}/metadata.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "transcription"])
        w.writerows(rows)


# device ms of step 4 by training path: attention backward, W8A8, all
# kernels, and the step's end-to-end ms (printed as one JSON line)
STEP_DEVICE: dict = {}
ATTN_BWD = "attention backward (enc_attn_bwd_di/dkdv_wgmma, dq_store)"
W8A8 = "W8A8 (quantize_rows, w8a8_wgmma)"


def kernel_category(name: str) -> str:
    low = name.lower()
    if "enc_attn_bwd" in low:
        return ATTN_BWD
    if "enc_attn_fwd" in low:
        return "attention forward (enc_attn_fwd_*)"
    if "w8a8" in low or "quantize_rows" in low:
        return W8A8
    if "gemv_kernel" in low or "attn_partial" in low or "attn_combine" in low:
        return "decoder kernels (gemv, attn_partial, attn_combine)"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_")):
        return "matrix products (cuBLAS)"
    if "multi_tensor" in low or "foreach" in low:
        return "foreach (optimizer, norms)"
    if "conv" in low or "cudnn" in low:
        return "conv stem (cuDNN)"
    return "elementwise, reductions, copies"


def train_main_path(rows, device: str = "cuda", model: str = "large-v3",
                    extra=(), config: str = TRAIN_CONFIG, fused_qkv: bool = False):
    """Phase 6, the training main path: `asr_finetune_tpu_torch.cli.train`
    with the repo's largev3_debug.config (whisper-large-v3, full fine-tuning,
    batch 4, AdamW b2 0.98, bf16 compute over fp32 master weights, per-layer
    remat, log-mel on the device, fused chunked CE), random init from its
    seed, cut to 4 steps with an eval (loss + greedy-decode WER) and a
    checkpoint at step 4, on 20 seeded wavs (16 train, 4 validation). Asserts
    finite loss and grad norm, changed parameters, the eval record's
    eval_loss_wer = 0.3 loss + 0.7 wer, the checkpoint, and every kernel's
    launch count; prints the training figures and where one step's device
    time goes (torch.profiler over step 4). `device`, `model` and `extra`
    (more CLI flags) let the same function run a small model on the CPU.

    Phase 7 is the same function with config=PEFT_CONFIG and extra
    ("--int8_matmul",): AdaLoRA adapters over the int8 base, every frozen
    product through the W8A8 kernel. It then asserts changed adapters and an
    unchanged base, an adapter-only checkpoint, the W8A8 and int8-weight
    decoder launch counts, and prints the calibrated outlier columns.

    Phase 7b is phase 7 with fused_qkv, under ASR_TPU_FUSED_QKV=1: the steps
    and the eval loss run every encoder layer's q/k/v as one W8A8 product of
    d -> 3d into the fused-qkv attention kernel (backward too); the outlier
    calibration stays on the three projections, as the JAX trial's does, so
    it records no (d, 3d) class and the wide product takes the dynamic top-k
    outlier form, which is asserted product by product; the eval decode's
    merged base is mixed int8/float and keeps the three projections."""
    import os
    import shutil
    import torch
    from torch.profiler import ProfilerActivity, profile
    from asr_finetune_tpu_torch import run as run_lib
    from asr_finetune_tpu_torch.cli import train as train_cli
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.ops import quant as Q
    from asr_finetune_tpu_torch.training import checkpoint as ckpt_lib
    from asr_finetune_tpu_torch.training import trainer as trainer_lib

    on_card = device == "cuda"
    peft = config == PEFT_CONFIG
    int8_matmul = "--int8_matmul" in extra
    tag = next(line.split("=", 1)[1].strip() for line in open(config)
               if line.startswith("output_tag"))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    st = {"steps": [], "evals": 0, "dec_steps": 0, "saves": [], "eval_s": 0.0,
          "calib": None, "outliers": {}}
    orig = (trainer_lib.make_train_step, trainer_lib.make_eval_loss_step,
            W.decode_step_fused, ckpt_lib.CheckpointManager.save,
            trainer_lib.Trainer.evaluate, run_lib.calibrate_outliers, Q._outlier_split)

    def outlier_split(x, w_q8, w_scale, cfg):
        """Counts the W8A8 products by (d_in, d_out) class and outlier form."""
        klass = (x.shape[-1], w_q8.shape[-1])
        static = cfg.static_idx is not None and klass in cfg.static_idx
        key = (klass, "calibrated" if static else "dynamic top-k")
        st["outliers"][key] = st["outliers"].get(key, 0) + 1
        return orig[6](x, w_q8, w_scale, cfg)

    def calibrate_outliers(*a, **k):
        st["calib"] = orig[5](*a, **k)
        return st["calib"]

    def make_train_step(*a, **k):
        inner = orig[0](*a, **k)

        def step(state, batch):
            if not st["steps"]:
                st["state"] = state
                st["before"] = {n: t.detach().clone() for n, t in _probe(state)}
            sync()
            t0, u0 = time.perf_counter(), host_usage()
            if len(st["steps"]) == TRAIN_STEPS - 1 and on_card:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    m = inner(state, batch)
                    sync()
                st["prof"] = prof
            else:
                m = inner(state, batch)
                sync()
            st["steps"].append({"s": time.perf_counter() - t0,
                                "usage": host_usage() - u0,
                                "loss": float(m["loss"]),
                                "grad_norm": float(m["grad_norm"]),
                                "tokens": int(m["tokens"]),
                                "shape": tuple(batch["labels"].shape)})
            return m
        return step

    def make_eval_loss_step(*a, **k):
        inner = orig[1](*a, **k)

        def step(state, batch):
            st["evals"] += 1
            return inner(state, batch)
        return step

    def decode_step_fused(*a, **k):
        st["dec_steps"] += 1
        return orig[2](*a, **k)

    def save(self, step, state, metrics=None):
        # the checkpoint is fp32 params + both AdamW moments: check the disk first
        need = sum(t.numel() * t.element_size() for t in state["opt_state"]["mu"]) * 3
        free = shutil.disk_usage(self.directory).free
        if free < need * 1.05 + 2 ** 30:
            raise RuntimeError(f"checkpoint of step {step} needs {need / 1e9:.1f} GB, "
                               f"{free / 1e9:.1f} GB free under {self.directory}")
        sync()
        t0 = time.perf_counter()
        saved = orig[3](self, step, state, metrics)
        if saved:
            d = os.path.join(self.directory, f"step_{step:08d}")
            size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
            st["saves"].append((step, time.perf_counter() - t0, size))
        return saved

    def evaluate(self, step):
        sync()
        t0 = time.perf_counter()
        out = orig[4](self, step)
        sync()
        st["eval_s"] += time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        data, out_dir = f"{tmp}/data", f"{tmp}/out"
        os.makedirs(data)
        write_audiofolder(data, TRAIN_UTTS)
        argv = ["-c", config, "--model_type", model, "--device", device,
                "--no-debug", "--data_mode", "folder", "--dataset_name", data,
                "--val_split", "0.2", "--max_steps", str(TRAIN_STEPS),
                "--eval_steps", str(TRAIN_STEPS), "--save_steps", str(TRAIN_STEPS),
                "--logging_steps", "2", "--eval_sample_fraction", "1.0",
                "--generation_max_length", str(TRAIN_GEN_LEN), "--wer_weight", "0.7",
                "--output_dir", out_dir, *extra]
        (trainer_lib.make_train_step, trainer_lib.make_eval_loss_step,
         W.decode_step_fused, ckpt_lib.CheckpointManager.save,
         trainer_lib.Trainer.evaluate, run_lib.calibrate_outliers, Q._outlier_split) = (
            make_train_step, make_eval_loss_step, decode_step_fused, save, evaluate,
            calibrate_outliers, outlier_split)
        if fused_qkv:
            os.environ["ASR_TPU_FUSED_QKV"] = "1"
        reset_all_launches()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            result = train_cli.main(argv)
        finally:
            (trainer_lib.make_train_step, trainer_lib.make_eval_loss_step,
             W.decode_step_fused, ckpt_lib.CheckpointManager.save,
             trainer_lib.Trainer.evaluate, run_lib.calibrate_outliers,
             Q._outlier_split) = orig
            os.environ.pop("ASR_TPU_FUSED_QKV", None)
        sync()
        wall = time.perf_counter() - t0
        launches = all_launches()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        run_dir = f"{out_dir}/{tag}"
        with open(f"{run_dir}/metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        ckpts = sorted(os.listdir(f"{run_dir}/checkpoints"))
        saved_keys = sorted(torch.load(
            f"{run_dir}/checkpoints/{ckpts[-1]}/state.pt", map_location="cpu",
            weights_only=True)) if ckpts else []
        changed = {n: float((t.detach().float() - st["before"][n].float()).abs().max())
                   for n, t in _probe(st["state"])}
        del st["state"], st["before"]

    steps = st["steps"]
    label = ("PEFT main path" if peft else "train main path") + (
        " (fused qkv)" if fused_qkv else "")
    print(f"{label}: cli.train -c {config} {' '.join(extra)}, {model}, {len(steps)} steps, "
          f"wall {wall:.3f} s incl. model init, data, eval and checkpoint; result "
          f"{json.dumps(result)}")
    for i, s in enumerate(steps):
        print(f"  step {i + 1}: {1e3 * s['s']:.3f} ms ({host_usage_text(s['usage'])})  "
              f"loss {s['loss']:.5f}  grad_norm {s['grad_norm']:.5f}  tokens "
              f"{s['tokens']}  labels {s['shape']}")
    if len(steps) != TRAIN_STEPS or not all(
            np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps):
        raise AssertionError(f"expected {TRAIN_STEPS} steps with finite loss and grad norm")
    if any(s["shape"] != (B, CROSS_TQ) for s in steps):
        raise AssertionError(f"labels not at batch {B} x the {CROSS_TQ} bucket")
    frozen = {n: v for n, v in changed.items() if n.startswith("base.")}
    trained = {n: v for n, v in changed.items() if not n.startswith("base.")}
    if not all(v > 0 for v in trained.values()) or any(v != 0 for v in frozen.values()):
        raise AssertionError(f"trained leaves did not change or the frozen base did: "
                             f"{changed}")
    want_keys = (["adapters", "mu", "nu", "opt_count", "rank_mask", "sensitivity", "step"]
                 if peft else ["mu", "nu", "opt_count", "params", "step"])
    if saved_keys != want_keys:
        raise AssertionError(f"checkpoint holds {saved_keys}, expected {want_keys}")
    evals = [r for r in records if "eval_loss_wer" in r]
    if len(evals) != 1 or evals[0]["step"] != TRAIN_STEPS:
        raise AssertionError(f"expected one eval record at step {TRAIN_STEPS}: {records}")
    ev = evals[0]
    fused = 0.3 * ev["eval_loss"] + 0.7 * ev["eval_wer"]
    if not np.isfinite(ev["eval_loss_wer"]) or abs(ev["eval_loss_wer"] - fused) > 1e-6 * abs(fused):
        raise AssertionError(f"eval_loss_wer {ev['eval_loss_wer']} != 0.3 loss + 0.7 wer "
                             f"= {fused}")
    if ckpts != [f"step_{TRAIN_STEPS:08d}"] or [s for s, _, _ in st["saves"]] != [TRAIN_STEPS]:
        raise AssertionError(f"expected one checkpoint at step {TRAIN_STEPS}: {ckpts}, "
                             f"{st['saves']}")
    # per step: 32 encoder + 32 cross-attention forwards, again in the remat
    # recompute, and their 64 backwards; per eval batch: the loss pass's 64
    # forwards and the decode's 32 encoder forwards; the outlier
    # calibration's forward (PEFT with --int8_matmul) 64 more; per decode
    # step one launch of each decoder kernel in each of the 32 layers
    from asr_finetune_tpu_torch.models.configs import get_config
    n_enc, n_dec = 32, 32
    if model != "large-v3":
        n_enc, n_dec = get_config(model).encoder_layers, get_config(model).decoder_layers
    # PEFT: the decoder kernels run with int8 weights (k, o, fc1, fc2 of the
    # merged base); with --int8_matmul each frozen product is a W8A8 launch:
    # 6 per encoder and 10 per decoder layer in a forward, twice a step
    # (remat), once in the calibration forward and in each eval loss pass,
    # and per eval decode the encoder's k/o/fc1/fc2 and the cross k
    # projections (q/v are merged float)
    #
    # Fused qkv (7b): a step's and an eval loss pass's encoder runs q|k|v as
    # one product and the fused-qkv attention kernels (4 W8A8 per encoder
    # layer); the calibration and the eval decode (a merged, mixed base) keep
    # the three projections and the packed kernel.
    mm = 6 * n_enc + 10 * n_dec
    mm_step = (4 if fused_qkv else 6) * n_enc + 10 * n_dec
    calibrated = int(st["calib"] is not None)
    dec = {k + ("_int8" if peft else ""): n_dec * st["dec_steps"] for k in DECODER}
    step_fwd = TRAIN_STEPS * 2 + st["evals"]        # training forwards, remat included
    enc_fwd = dict(encoder_attention_qkv=step_fwd * n_enc,
                   encoder_attention_qkv_bwd=TRAIN_STEPS * n_enc) if fused_qkv else {}
    expect = expect_launches(
        encoder_attention=(step_fwd * (0 if fused_qkv else n_enc) + step_fwd * n_dec
                           + calibrated * (n_enc + n_dec) + st["evals"] * n_enc),
        encoder_attention_bwd=TRAIN_STEPS * ((0 if fused_qkv else n_enc) + n_dec),
        w8a8=(mm_step * step_fwd + mm * calibrated + st["evals"] * (4 * n_enc + n_dec)
              if int8_matmul and on_card else 0),
        **enc_fwd, **dec)
    if st["evals"] != 1 or st["dec_steps"] == 0 or calibrated != int8_matmul \
            or launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect} "
                             f"({st['evals']} eval batches, {st['dec_steps']} decode steps)")
    if int8_matmul:
        # with --int8_matmul (k 8), each W8A8 product's outlier form by class:
        # the calibration's (dynamic, it records), then the calibrated classes;
        # the fused path's wide (d, 3d) class is never calibrated
        d = (get_config(model) if model != "large-v3" else None)
        d_model = d.d_model if d is not None else D
        wide = ((d_model, 3 * d_model), "dynamic top-k")
        print(f"{label}: W8A8 products by (d_in, d_out) class and outlier form: "
              + ", ".join(f"{k[0]} {k[1]}: {n}" for k, n in sorted(st["outliers"].items())))
        if st["calib"] is not None and (d_model, 3 * d_model) in st["calib"]:
            raise AssertionError(f"the calibration recorded the wide class: {st['calib']}")
        if st["outliers"].get(wide, 0) != (step_fwd * n_enc if fused_qkv else 0):
            raise AssertionError(f"wide products in the dynamic form: "
                                 f"{st['outliers'].get(wide, 0)} != {step_fwd * n_enc}")
    record_launches(rows, ("peft" if peft else "train") + ("_fused_qkv" if fused_qkv else ""),
                    launches)
    step_s = float(np.mean([s["s"] for s in steps[1:-1]]))
    usage = np.mean([s["usage"] for s in steps[1:-1]], axis=0)
    tokens = float(np.mean([s["tokens"] for s in steps[1:-1]]))
    save_step, save_s, save_bytes = st["saves"][0]
    if st["calib"] is not None:
        print(f"{label}: calibrated outlier columns per (d_in, d_out) class: "
              + ", ".join(f"{k}: {len(v)} {list(v)}" for k, v in sorted(st["calib"].items())))
    print(f"{label}: {1e3 * step_s:.3f} ms/step end to end (steps 2-3; step 1 "
          f"{1e3 * steps[0]['s']:.3f} ms); {B / step_s:.3f} utterances/s; "
          f"{tokens / step_s:.1f} label tokens/s; peak memory {peak / 2**30:.2f} GiB; "
          f"per step {host_usage_text(usage)}")
    print(f"{label}: eval {st['eval_s']:.3f} s ({st['evals']} batch, "
          f"{st['dec_steps']} decode steps); eval_loss {ev['eval_loss']:.5f} eval_wer "
          f"{ev['eval_wer']:.3f} eval_loss_wer {ev['eval_loss_wer']:.5f}")
    print(f"{label}: checkpoint of step {save_step}: {save_bytes / 1e9:.3f} GB "
          f"written in {save_s:.3f} s ({save_bytes / 1e9 / save_s:.3f} GB/s), then deleted")
    print(f"{label}: launches {json.dumps(launches)}")
    if on_card:
        by_kernel = kernel_times(st["prof"], 1)
        busy = sum(ms for ms, _, _ in by_kernel)
        cats: dict = {}
        for ms, n, key in by_kernel:
            c = cats.setdefault(kernel_category(key), [0.0, 0])
            c[0] += ms
            c[1] += int(n)
        print(f"{label}, step 4 by CUDA kernel (torch.profiler): device busy {busy:.3f} ms "
              f"of {1e3 * step_s:.3f} ms/step -> device idle {100 * (1 - busy / (1e3 * step_s)):.1f}% "
              f"of an unprofiled step")
        for c, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {n:6d} launches  {c}")
        ab, w8 = cats.get(ATTN_BWD, [0.0, 0]), cats.get(W8A8, [0.0, 0])
        print(f"{label}, step 4: attention backward {ab[0]:.3f} ms ({ab[1]} launches), "
              f"W8A8 {w8[0]:.3f} ms ({w8[1]} launches) of {busy:.3f} ms device time; "
              f"{1e3 * step_s:.3f} ms/step, device idle {100 * (1 - busy / (1e3 * step_s)):.1f}%")
        STEP_DEVICE[label] = {"attention_bwd_ms": ab[0], "w8a8_ms": w8[0], "busy_ms": busy,
                              "step_ms": 1e3 * step_s}
        print("  largest kernels:")
        for ms, n, key in by_kernel[:12]:
            print(f"  {ms:9.3f} ms  {int(n):6d} launches  {key[:90]}")
        by_op = host_times(st["prof"])
        print(f"{label}, step 4 on the host (torch.profiler, self time): "
              f"{sum(ms for ms, _, _ in by_op):.3f} ms in {sum(n for _, n, _ in by_op)} "
              f"events; largest:")
        for ms, n, key in by_op[:12]:
            print(f"  {ms:9.3f} ms  {n:6d} calls  {key[:90]}")


def _probe(state):
    """A few leaves whose change shows the update reached the whole model:
    full fine-tuning the first encoder layer's q, the last decoder layer's
    fc2, the tied embedding; PEFT the encoder q adapter's a, the decoder
    cross-attention v adapter's b and, named "base.*", two frozen leaves."""
    p = state["params"]
    if "adapters" not in state:
        return [("encoder.attn.q.w", p["encoder"]["layers"]["attn"]["q"]["w"]),
                ("decoder.mlp.fc2.w", p["decoder"]["layers"]["mlp"]["fc2"]["w"]),
                ("decoder.embed", p["decoder"]["embed"])]
    ad = state["adapters"]
    k = p["encoder"]["layers"]["attn"]["k"]
    return [("adapters.encoder.q.a", ad["encoder"]["q"]["a"]),
            ("adapters.decoder.cross_attn.v.b", ad["decoder"]["cross_attn"]["v"]["b"]),
            ("base.encoder.attn.k", k["w_q8"] if "w_q8" in k else k["w"]),
            ("base.decoder.embed", p["decoder"]["embed"])]


def step_breakdown():
    """One whisper-large-v3 decode step at batch 4 (bf16, cache 128 at pos
    63), greedy and on each beam path (4 x 4 hypothesis rows over cross K/V
    of 4: through the ancestry map, with int8 cross K/V, and with the cache
    reordered on the beam axis instead, that reorder included): device time
    (a CUDA graph of the step, replayed) against the eager step, which the
    host's launches bound; device time by CUDA kernel, and the launch counts
    per step the path implies."""
    import torch
    from asr_finetune_tpu_torch.evaluation import decode as decode_lib
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.models.configs import get_config
    from asr_finetune_tpu_torch.ops import decoder_fused as DF
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("large-v3")
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    params = decode_lib._cast_decoder_weights(
        W.init_params(cfg, seed=0, device=dev), bf16)
    g = torch.Generator(device=dev).manual_seed(3)
    ckv = {k: torch.randn((L, B, S_PAD, D), generator=g, device=dev).to(bf16)
           for k in ("k", "v")}
    k8, v8, ks, vs = int8_cross((ckv["k"], ckv["v"]), bf16)
    ckv8 = {"k_q8": k8, "v_q8": v8, "k_scale_d": ks, "v_scale_d": vs}
    logits_w = W.tied_logits_weight(params["decoder"]["embed"], bf16)
    rows_b = B * BEAMS
    anc = torch.randint(0, BEAMS, (B, BEAMS, SELF_T), generator=g, device=dev,
                        dtype=torch.int32)
    perm = (torch.arange(B, device=dev)[:, None] * BEAMS
            + torch.randint(0, BEAMS, (B, BEAMS), generator=g, device=dev)).reshape(-1)
    variants = {   # name: (rows, cross K/V, ancestry, reorder)
        "greedy": (B, ckv, None, False),
        f"beam{BEAMS}": (rows_b, ckv, anc, False),
        f"beam{BEAMS} int8 cross K/V": (rows_b, ckv8, anc, False),
        f"beam{BEAMS} cache reorder": (rows_b, ckv, None, True),
    }
    for name, (n, cross, ancestry, reorder) in variants.items():
        cache = W.init_cache(cfg, n, SELF_T, bf16, dense=True, device=dev)
        tok = torch.zeros((n,), dtype=torch.long, device=dev)
        group = n // B
        scratch = {k: torch.empty_like(v) for k, v in cache.items()} if reorder else None

        def step():
            W.decode_step_fused(params, tok, SELF_POS, cache, cross, cfg, T_ENC, bf16,
                                logits_w, ancestry=ancestry, cross_group=group)
            if reorder:   # what beam_decode's reorder path adds: the whole cache gathered
                for k, v in cache.items():
                    torch.index_select(v, 1, perm, out=scratch[k])

        dev_ms = device_ms(step, calls=4)
        host_ms = eager_ms(step, iters=8)
        print(f"decode step {name}, large-v3 {n} rows bf16: device {dev_ms:.3f} ms (graph "
              f"replay), eager {host_ms:.3f} ms -> device busy "
              f"{100 * dev_ms / host_ms:.1f}% of the eager step")
        # device time by CUDA kernel over 4 eager steps after one warm-up
        # step (torch.profiler, CUPTI); only the kernels themselves: CPU ops
        # such as aten::copy_ also carry their kernels' device time and
        # would count it twice
        traces = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(wait=0, warmup=1, active=4),
                     on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
            for _ in range(5):
                step()
                torch.cuda.synchronize()
                prof.step()
        by_kernel = sorted(((e.self_device_time_total, e.count, e.key)
                            for e in traces[0]
                            if e.device_type == DeviceType.CUDA
                            and e.self_device_time_total > 0
                            and not e.key.startswith("ProfilerStep")),
                           reverse=True)
        total = sum(t for t, _, _ in by_kernel)
        print(f"decode step {name} by CUDA kernel (profiler, per step; device total "
              f"{total / 4e3:.3f} ms):")
        for t, c, key in by_kernel[:8]:
            print(f"  {t / 4e3:8.3f} ms  {c // 4:5d} launches  {key[:90]}")
        # CUDA launches per step, as the library counts them where it
        # launches (the profiler drops kernel records at this rate): per
        # layer the qkv, cross q, two wo and fc1/fc2 GEMVs, one launch per
        # group of at most 8 rows, and a partial and a combine per attention
        DF.reset_kernel_launches()
        for _ in range(4):
            step()
        torch.cuda.synchronize()
        per_step = {k: v / 4 for k, v in DF.kernel_launches().items()}
        want = {"gemv_kernel": 6 * -(-n // 8) * L, "attn_partial_kernel": 2 * L,
                "attn_combine_kernel": 2 * L}
        print(f"decode step {name}: CUDA kernel launches per step {per_step}")
        if per_step != want:
            raise AssertionError(f"decode step {name}: kernel launches {per_step} != {want}")
        del cache, scratch
    del params, ckv, ckv8
    torch.cuda.empty_cache()


def build():
    from asr_finetune_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built from {_build.CSRC} in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.sources())})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from asr_finetune_tpu_torch.device import resolve_device
    resolve_device("cuda")   # pins fp32 products to fp32 (no TF32)
    build()
    rows = {}
    check_decoder_kernels(rows)
    check_encoder_attention(rows)
    check_attention_bwd(rows)
    check_w8a8(rows)
    check_attention_layouts(rows)
    check_log_mel(rows)
    check_decode()
    check_int8_decode()
    check_beam_decode()
    check_train_grads()
    check_peft_grads()
    check_layout_paths()
    main_path(rows)
    main_path(rows, beams=BEAMS)
    main_path(rows, beams=BEAMS, kv_int8=True)
    main_path(rows, beams=BEAMS, reorder=True)
    main_path(rows, fused_qkv=True)
    evaluator_path(rows)
    train_main_path(rows)
    train_main_path(rows, config=PEFT_CONFIG, extra=("--int8_matmul",))
    train_main_path(rows, config=PEFT_CONFIG, extra=("--int8_matmul",), fused_qkv=True)
    step_breakdown()
    print(json.dumps({"step_device_ms": STEP_DEVICE}))
    print(card_line())
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

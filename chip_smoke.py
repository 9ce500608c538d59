#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (asr_finetune_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card, nvcc

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from csrc/ (one nvcc per source, in parallel)
   and the host C++ library (csrc/asr_native.cpp, g++);
3. holds every kernel against its plain PyTorch version at whisper-large-v3
   shapes (B=4, and the decoder kernels also at 12 rows, fused_qkv and
   fused_mlp at 16, fused_mlp with int8 fc1 at 32) in bf16 and fp32, within
   the limits stated at F32_LIMITS, the bf16 fused_qkv, fused_mlp,
   fused_attn and fused_attn_beam also to bit equality between two calls
   (fused_qkv also in its
   cache form: k and v into a self cache's row pos, nothing else touched),
   and times kernel,
   plain version and, for the encoder attention,
   F.scaled_dot_product_attention as a yardstick (the
   port never calls it): the decoder kernels over float, mixed int8/float
   and all-int8 weights; the encoder-attention forward and its backward at
   the encoder's self-attention and the teacher-forced cross-attention shapes,
   with the forward's logsumexp, and SDPA's backward as its yardstick; the
   W8A8 kernel bit for bit at the PEFT main path's six product shapes, pure
   and with the outlier keep-mask and addend, timed beside torch._int_mm (the
   int8 dot alone) and the bf16 product with the dequantized weight; the
   beam path's attention at 4 utterances x 4 beams: the beam
   self-attention through an ancestry map, the cross-attention over K/V
   shared per utterance
   (kv_group 4) and over int8 K/V (G = 1 and 4); both again at 2 x 10
   beams, wider than the Pallas kernels' 8; the encoder-attention kernels on
   the (BH, T, hd) layout (80 x 1536 rows, keys valid below 1500) and on one
   fused (4, 1500, 3840) qkv buffer, forward and backward, with SDPA as the
   yardstick; W8A8 also at the fused q|k|v product 1280 -> 3840; the log-mel
   kernel (fp32: an FFT in shared memory, band sums, the floor in the call)
   at B 4, 80 and 128 mels, two calls bit-equal, its two CUDA launches a
   call asserted, the production conv form (ops/logmel.log_mel_spectrogram,
   tables resident) and a torch.stft form as its yardsticks, and its and the
   plain version's error against float64 on a tonal input; 3g, the kernels
   at the shapes a rank of --tp 2 gives them: W8A8 with the row amax
   supplied, bit for bit, at the eight split products (and four of --tp 4,
   N or K 320), timed; the encoder-attention kernels at 10 heads, packed
   and fused-qkv, forward and backward, within the 20-head limits;
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
   kernel's launch count against the count the path implies (and each
   decode path's CUDA kernels: no GEMV, partial or combine in bf16), prints
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
   7c. the HPO main path: `asr_finetune_tpu_torch.cli.train_hyper` with
   largev3_peft_debug.config and --int8_matmul, TPE search with ASHA, 3
   trials of large-v3 at their own AdaLoRA ranks, each 4 steps with an eval
   and a checkpoint every 2, one line per trial (hp, status, ASHA
   decisions, wall, ms/step, peak memory, launches); asserts no trial
   errored, every trial launched W8A8, the attention kernels and the int8
   decoder kernels, and the device memory came back after each trial; then
   --resume_training runs nothing, `cli.export` writes the best trial merged
   (no K-major copy), `cli.transcribe --model_path` serves it through the
   decoder kernels with tokens equal to the plain decode's, and
   `cli.prepare_model --verify` converts an HF directory it writes;
   7d. trial packing: `cli.train_hyper --chips_per_trial k
   --max_concurrent_trials 2` over rank processes sharing the card (gloo),
   7c's flags with random search and 2 steps a trial: (i) two ranks, k 1,
   4 trials, against one process running them one after another (every
   trial once, two at once, hp equal, step losses within DP_LIMITS, the
   kernels launched and the memory back after each trial, a resume that
   runs nothing); (ii) four ranks, k 2, 2 trials of two data ranks each,
   against one process at the global batch; one JSON line each;
8. data parallelism and offload (asr_finetune_tpu_torch/parallel/): 8a, two
   rank processes of `cli.train` sharing the card (a gloo group),
   large-v3 PEFT over the int8 base with --int8_matmul and AdaLoRA, 2 rows
   a rank, 4 steps, evals at steps 2 and 4, a checkpoint at 4, against one
   process at batch 4 over the same global batches (loss, grad_norm and
   adapters within DP_LIMITS), the ranks' evals, adapters and rank masks
   equal, every kernel of the path launched on each rank, the checkpoint
   resumed in one process; 8b, full fine-tuning with --offload_optimizer
   in one rank of an NCCL group, 3 steps bit-equal to resident (both on
   plain attention with deterministic algorithms: the bf16 attention
   backward's dq varies run to run) with m and v pinned on the host
   between steps, then on the kernels, peak memory and ms/step against
   phase 6; 8c, PEFT-int8 with --offload_param --offload_optimizer, 3
   steps and an eval, the same way against phase 7, the base pinned on the
   host and the device memory back after each step; 8d, tensor
   parallelism: two rank processes of `cli.train --tp 2` sharing the card
   (gloo), large-v3 (i) full fine-tuning and (ii) PEFT over the int8 base
   with --int8_matmul, AdaLoRA and calibrated outliers, 4 steps of batch 4,
   an eval and a checkpoint at step 4, each against one process at tp 1
   over the same batches (loss, grad_norm, the trained weights within
   TP_LIMITS; the calibrated sets equal, the rank masks equal on both
   ranks), the kernels launched on each rank (W8A8 at the split shapes),
   the checkpoint resumed in one process, ms/step, peak memory a rank and
   the collectives' share of a step; each one JSON line of its readings;
9. the training options: 9a, `cli.train` at whisper-small,
   full fine-tuning with --spec_augment at batch 8 (bench.py's full_ft
   cell), 4 steps, an eval and a checkpoint, after checking the draws on
   the card (a stream repeats, another differs, widths and starts within
   the JAX law, no sync and no device-to-host copy in a masking call); 9b,
   phase 7 with --host_logmel (the collator's float64 log-mel in the
   prefetch thread, timed; the calibration on a mel batch), its step-1 loss
   and calibrated columns against phase 7's; 9c, large-v3 full fine-tuning
   under ASR_TPU_REMAT_SAVE=mid, enc, enc+dec and without remat: bit-equal
   losses and grad norms on plain attention, then on the kernels ms/step,
   peak memory and the attention launches of each mode;
10. the last modules of the JAX package: 10a, the host C++ path
   (utils/native_ext, built with g++ in step 2) equal to its Python
   versions on seeded inputs (200 edit distances, corpus_wer over 2,000
   pairs, the collator's audio batch bit for bit at B 8 below and above
   the 30 s window), its host times against Python's, and the evaluator's
   corpus WER equal to the Python WER of its transcripts; 10b,
   `cli.classify` on the evaluator's eval_final.json, rule-based, and with
   transformers the LLM judge on the card over a tiny random GPT-2; 10c,
   `cli.verify_parity` at whisper-small's widths on the card (a random HF
   checkpoint written with save_pretrained): every stage must pass, the
   decodes through the fused decoder kernels; without transformers the
   CLI must raise ImportError naming it, and the run says so;
11. one decode step's device time by CUDA kernel, greedy and on each beam
   path, with the launches per step asserted; then the card line again,
   one JSON line `{"kernels": [...]}`, and last `{"ok": true, "device": {...}}`.

Any failed check raises: the script then exits non-zero and prints no
result line. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
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
               ("encoder q|k|v fused", B * T_ENC, D, 3 * D),
               # Uni-MoE-2.0-Omni's dynamic experts at about one expert's rows
               # of a batch of 8: the down-projection's K past 8192 (the
               # two-pass quantize kernel), the gate/up's N
               ("unimoe expert down", 1536, 18944, 3584),
               ("unimoe expert gate/up", 1536, 3584, 18944))
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
    # fused_mlp with int8 fc1 and fc2 at the beam path's 16 rows, the same
    # rule over the first readings there: the tensor-core kernel and the
    # GEMV kernel it replaced both read (1.78e-4, 1.27e-4 / 1.23e-4) on an
    # H100, over fused_mlp_int8's atol, from the plain version's own fp32
    # product: an fp64 product moves no g the kernel rounds (PERF.md)
    "fused_mlp_int8_r16": (7.2e-4, 5.1e-4),
    # fused_mlp with int8 fc1 at 32 rows (a beam-8 decode of 4 utterances
    # over a merged int8 base), fc2 int8 or float, the same rule over the
    # readings at 32 rows on an H100 (tools/bench_fused_mlp.py --check, fc2
    # float: 3.55e-4, 1.59e-4): an fp64 product of the same bf16 LN(x) puts
    # the kernel's g no further from it than the plain version's fp32
    # product (13 / 19 g values rounded otherwise, against 18 / 21); the
    # excess is single g values at a rounding boundary that either product
    # may round the other way (PERF.md)
    "fused_mlp_int8_r32": (1.42e-3, 6.4e-4),
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
# fused_qkv and fused_mlp at the beam path's 16 rows (4 utterances x 4
# beams): the same kernels, timed at a second shape
REPLACES.update({k + "_r16": REPLACES[k] for k in ("fused_mlp", "fused_mlp_int8", "fused_qkv",
                                                  "fused_qkv_int8")})
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


def same_bits(name, out, again) -> None:
    """Two calls of a kernel on the same inputs must give the same bits
    (tuples element by element)."""
    import torch
    outs, agains = (t if isinstance(t, tuple) else (t,) for t in (out, again))
    if not all(torch.equal(a, b) for a, b in zip(outs, agains)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    print(f"{name}: two calls bit-equal")


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
    if name.startswith("fused_"):   # the CUDA kernels one call launches, by name
        from asr_finetune_tpu_torch.ops import decoder_fused as DF
        DF.reset_kernel_launches()
        fn()
        rows[name]["cuda_kernels"] = {k: v for k, v in DF.kernel_launches().items() if v}
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
    4) with one layer's weights unstacked. fused_qkv and fused_mlp also at
    the beam path's 16 rows; in bf16 (the tensor-core kernels) two calls of
    fused_qkv, fused_mlp, fused_attn or fused_attn_beam must give the same
    bits, and
    fused_qkv's cache form (k and v into row SELF_POS of layer 31 of the
    main path's (32, 4, 128, d) self cache) must write the bits of the call
    without one there and nowhere else. In bf16 the main path's shapes
    (B=4, and fused_qkv and fused_mlp at 16 rows: "fused_qkv_r16",
    "fused_qkv_int8_r16", "fused_mlp_r16", "fused_mlp_int8_r16") are timed
    with the calls cycling through the 32 layers, against a bound that
    counts each operand read and each output written once: float weights
    give the "fused_*" rows, mixed the "fused_*_int8" rows. fused_mlp with
    int8 fc1 at 32 rows, fc2 int8 or float ("fused_mlp_int8_r32"), in both
    dtypes.
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
                    if dt is torch.bfloat16:
                        same_bits(name + sfx, out, fn(L - 1))
                    if dt is torch.bfloat16 and n_rows == B and kind != "all-int8":
                        it = iter(range(10 ** 9))
                        time_row(rows, name + sfx, err, lambda: fn(next(it) % L), plain,
                                 nbytes(*reads) + nbytes(*(out if isinstance(out, tuple)
                                                           else (out,))), flops, dn)
            # fused_qkv's cache form at B = 4: k and v into row SELF_POS of
            # layer 31 of the self cache, nothing else written
            if dt is torch.bfloat16:
                check_qkv_cache(DF, x, w, b, ln, kv[B]["self"], kind)
            # fused_qkv and fused_mlp at the beam path's 16 rows, one pass of
            # the bf16 tensor-core kernels (stacked weights, layer 31 of 32)
            calls16 = decoder_calls(DF, xb, qb, w, b, ln, kv[B], SELF_POS, True)
            for name in ("fused_qkv", "fused_mlp"):
                print(f"{name}, {kind} weights [{dn}] at {B * BEAMS} rows:")
                fn, plain, reads, flops = calls16[name]
                out = fn(L - 1)
                err = compare(name + sfx + ("_r16" if int8 and name == "fused_mlp" else ""),
                              out, plain(), dn)
                if dt is torch.bfloat16:
                    same_bits(name + sfx, out, fn(L - 1))
                    if kind != "all-int8":
                        it = iter(range(10 ** 9))
                        time_row(rows, name + sfx + "_r16", err, lambda: fn(next(it) % L),
                                 plain, nbytes(*reads) + nbytes(*(out if isinstance(out, tuple)
                                                                  else (out,))), flops, dn)
            print(f"beam-path attention, {kind} weights [{dn}] at {B} x {BEAMS} rows (beam "
                  f"cache {SELF_T} pos {SELF_POS}, cross kv_group {BEAMS} and int8 K/V):")
            calls = beam_calls(DF, xb, qb, x, w, b, ln, beam_kv, anc, cross, cross8)
            for name, (fn, plain, reads, flops, extra_bytes) in calls.items():
                out = fn(L - 1)
                err = compare(name + sfx, out, plain(), dn)
                if dt is torch.bfloat16:
                    same_bits(name + sfx, out, fn(L - 1))
                if dt is torch.bfloat16 and kind != "all-int8":
                    it = iter(range(10 ** 9))
                    time_row(rows, name + sfx, err, lambda: fn(next(it) % L), plain,
                             nbytes(*reads, out) + extra_bytes, flops, dn)
            del w
        check_mlp_r32(DF, Q, w32, b, ln, rn(32, D), dn)
        if dt is torch.bfloat16:
            # the fixed cost of the tensor-core MLP: fused_mlp at ff=64 (one
            # column tile) is two launches, mlp_fc1_kernel (80 KB of W1 a
            # call over 1 block, x's rows, LN, GELU) and mlp_fc2_kernel (20
            # blocks, K split in one, the residual), next to nothing to stream
            w1e, b1e = rn(L, D, 64, scale=D ** -0.5), rn(L, 64, scale=0.1)
            w2e = rn(L, 64, D, scale=0.125)
            it = iter(range(10 ** 9))
            DF.reset_kernel_launches()
            DF.fused_mlp(x, *ln, w1e, b1e, w2e, b["fc2"], layer_idx=0)
            probe = {k: v for k, v in DF.kernel_launches().items() if v}
            ms = device_ms(lambda: DF.fused_mlp(x, *ln, w1e, b1e, w2e, b["fc2"],
                                                layer_idx=next(it) % L), 64)
            print(f"  fused_mlp at ff=64 ({sum(probe.values())} launches a call: {probe}) "
                  f"[{dn}]: {ms:.4f} ms")
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
        out = DF.fused_attn_beam(xw, kw, vw, wo1, bo1, q=qw, pos=SELF_POS, ancestry=ancw)
        compare("fused_attn_beam", out,
                DF.fused_attn_beam_plain(xw, kw, vw, wo1, bo1, qw, SELF_POS, ancw), dn)
        if dt is torch.bfloat16:
            same_bits("fused_attn_beam (2 x 10 rows)", out,
                      DF.fused_attn_beam(xw, kw, vw, wo1, bo1, q=qw, pos=SELF_POS, ancestry=ancw))
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


def check_qkv_cache(DF, x, w, b, ln, self_kv, kind) -> None:
    """bf16 fused_qkv's cache form at layer L-1 of the stacked (L, B,
    SELF_T, D) self cache: k and v land in row SELF_POS bit for bit as the
    call without a cache returns them, the returned k and v are views of
    those rows, and no other element of the cache changes."""
    import torch
    li = L - 1
    args = (x, *ln, w["q"][0], b["q"], w["k"][0], w["v"][0], b["v"])
    scales = dict(wq_scale=w["q"][1], wk_scale=w["k"][1], wv_scale=w["v"][1], layer_idx=li)
    ref = DF.fused_qkv(*args, **scales)
    ck, cv = (t.clone() for t in self_kv)
    want_k, want_v = ck.clone(), cv.clone()
    want_k[li, :, SELF_POS], want_v[li, :, SELF_POS] = ref[1], ref[2]
    q, k, v = DF.fused_qkv(*args, **scales, cache_k=ck, cache_v=cv, pos=SELF_POS)
    if not (torch.equal(q, ref[0]) and torch.equal(ck, want_k) and torch.equal(cv, want_v)
            and k.data_ptr() == ck[li, :, SELF_POS].data_ptr()
            and v.data_ptr() == cv[li, :, SELF_POS].data_ptr()):
        raise AssertionError(f"fused_qkv cache form, {kind} weights: the cache rows differ "
                             "from the call without a cache, or other elements changed")
    print(f"fused_qkv cache form, {kind} weights: row {SELF_POS} of layer {li} written bit "
          "for bit, nothing else")
    del ck, cv, want_k, want_v


def check_mlp_r32(DF, Q, w32, b, ln, x32, dn) -> None:
    """fused_mlp at 32 rows (one full pass of the bf16 tensor-core kernels)
    with int8 fc1 beside an int8 or a float fc2, stacked at layer L-1,
    against its plain version under "fused_mlp_int8_r32"; bf16 also two
    calls bit-equal."""
    import torch
    li = L - 1
    q1, q2 = Q.quantize_weight(w32["fc1"]), Q.quantize_weight(w32["fc2"])
    for label, w2, s2 in (("int8", q2[Q.QUANT_KEY], q2[Q.SCALE_KEY]),
                          ("mixed", w32["fc2"].to(x32.dtype), None)):
        def fn():
            return DF.fused_mlp(x32, *ln, q1[Q.QUANT_KEY], b["fc1"], w2, b["fc2"],
                                w1_scale=q1[Q.SCALE_KEY], w2_scale=s2, layer_idx=li)
        out = fn()
        print(f"fused_mlp at 32 rows, fc1 int8, fc2 {'int8' if s2 is not None else 'float'} "
              f"({label}) [{dn}]:")
        compare("fused_mlp_int8_r32", out,
                DF.fused_mlp_plain(x32, ln[0][li], ln[1][li], q1[Q.QUANT_KEY][li],
                                   b["fc1"][li], w2[li], b["fc2"][li],
                                   w1_scale=q1[Q.SCALE_KEY][li],
                                   w2_scale=None if s2 is None else s2[li]), dn)
        if x32.dtype == torch.bfloat16:
            same_bits(f"fused_mlp_int8_r32 ({label})", out, fn())
    del q1, q2


def check_encoder_attention(rows):
    """Phase 3b: the encoder-attention forward against its plain version at
    the encoder's self-attention (T 1500, and s_valid 1000) and the
    teacher-forced cross-attention (Tq 192, the main path's label bucket, Tk
    1500), bf16 and fp32; whether two calls give the same bits; bf16 timed at
    both shapes beside F.scaled_dot_product_attention as a yardstick (the
    port never calls it). The cross shape is held to the kernel's one limit
    (`encoder_attention`): the same kernel at another grid."""
    import torch
    import torch.nn.functional as F
    from asr_finetune_tpu_torch.ops import encoder_attention as EA

    dev = torch.device("cuda")
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(1)
        qe, ke, ve = ((torch.randn((B, T_ENC, D), generator=g, device=dev)).to(dt)
                      for _ in range(3))
        qc = torch.randn((B, CROSS_TQ, D), generator=g, device=dev).to(dt)
        worst = (0.0, 0.0)
        # s_valid < T masks the tail as the JAX kernel does
        for shape, q, s_valid in (("self", qe, T_ENC), ("self", qe, 1000),
                                  ("cross", qc, T_ENC)):
            out = EA.dense_attention_packed(q, ke, ve, 64, s_valid)
            ref = EA.dense_attention_packed_plain(q, ke, ve, 64, s_valid)
            print(f"encoder_attention [{dn}] {shape} Tq {q.shape[1]} Tk {T_ENC} "
                  f"s_valid {s_valid}:")
            err = compare("encoder_attention", out, ref, dn)
            worst = tuple(max(a, b) for a, b in zip(worst, err))
            print(f"  two calls bit-equal: "
                  f"{torch.equal(out, EA.dense_attention_packed(q, ke, ve, 64, s_valid))}")
        if dt is torch.bfloat16:
            def heads(a):
                return a.view(B, -1, H, 64).transpose(1, 2)
            time_row(rows, "encoder_attention", worst,
                     lambda: EA.dense_attention_packed(qe, ke, ve, 64, T_ENC),
                     lambda: EA.dense_attention_packed_plain(qe, ke, ve, 64, T_ENC),
                     4 * B * T_ENC * D * dt.itemsize, 4 * B * H * T_ENC * T_ENC * 64, dn,
                     library_fn=lambda: F.scaled_dot_product_attention(
                         heads(qe), heads(ke), heads(ve)), calls=8)
            b_ms, b_by = bound(2 * B * (CROSS_TQ + T_ENC) * D * dt.itemsize,
                               4 * B * H * CROSS_TQ * T_ENC * 64, dn)
            cross = {"ms": device_ms(lambda: EA.dense_attention_packed(qc, ke, ve, 64, T_ENC), 16),
                     "plain_ms": device_ms(
                         lambda: EA.dense_attention_packed_plain(qc, ke, ve, 64, T_ENC), 2),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                         heads(qc), heads(ke), heads(ve)), 16)}
            rows["encoder_attention"].update({f"cross_{k}": v for k, v in cross.items()})
            print(f"  encoder_attention [{dn}] cross Tq {CROSS_TQ} Tk {T_ENC}: kernel "
                  f"{cross['ms']:.4f} ms (device)  plain {cross['plain_ms']:.4f} ms  bound "
                  f"{b_ms:.4f} ms ({b_by})  library {cross['library_ms']:.4f} ms")
        del qe, ke, ve, qc, out, ref
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
    path's seven product shapes and Uni-MoE's two expert shapes (the
    down-projection's K 18944), bf16 and fp32, pure and with the outlier
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


# Phase 3g and 8d, tensor parallelism at --tp 2: each rank runs 10 of the 20
# heads and 1/2 of the MLP; the eight W8A8 products a rank runs, split by
# output columns (q/k/v, fc1: N / 2) or by input rows (o, fc2: K / 2, the row
# scale from the whole row's amax); and at --tp 4 the tile edges of N 320
# and K 320
TP, TP_H = 2, H // 2
TP_W8A8_SHAPES = tuple(
    (f"{part} {proj}", m, K, N)
    for part, m in (("encoder", B * T_ENC), ("decoder", B * CROSS_TQ))
    for proj, K, N in (("q/k/v", D, D // TP), ("o", D // TP, D), ("fc1", D, FF // TP),
                       ("fc2", FF // TP, D)))
TP4_W8A8_SHAPES = tuple((f"{part} {proj} (tp 4)", m, K, N)
                        for part, m in (("encoder", B * T_ENC), ("decoder", B * CROSS_TQ))
                        for proj, K, N in (("q/k/v", D, D // 4), ("o", D // 4, D)))


def check_tp_kernels(rows):
    """Phase 3g: the kernels at the shapes a rank of --tp 2 gives them.
    W8A8 with the row amax supplied (the whole row's, over the rank's K
    columns and the other rank's) against w8a8_plain with the same operand,
    bit for bit, bf16 and fp32, pure and with an outlier keep-mask and
    addend, at the eight split shapes and at four of --tp 4 (N or K 320:
    the tiles' ragged edges); the supplied amax must change the result (the
    kernel reads it). bf16 timed per tp 2 shape beside torch._int_mm and
    the bf16 product with the dequantized weight (rows["w8a8"]["tp2_by_shape"]).
    Then the encoder-attention kernels at 10 heads: packed (4, 1500, 640),
    self and cross (Tq 192), forward and backward, and the fused-qkv
    (4, 1500, 1920) buffer, forward and backward, against their plain
    versions at the 20-head limits; bf16 self timed beside SDPA
    (rows["encoder_attention"...]["h10_*"])."""
    import torch
    import torch.nn.functional as F
    from asr_finetune_tpu_torch.ops import encoder_attention as EA
    from asr_finetune_tpu_torch.ops import quant as Q
    from asr_finetune_tpu_torch.ops import w8a8_fused as WF

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    timed = []
    for name, m, K, N in TP_W8A8_SHAPES + TP4_W8A8_SHAPES:
        q = Q.quantize_weight(torch.randn((K, N), generator=g, device=dev) * K ** -0.5)
        w8, ws = q["w_q8"], q["w_scale"]
        w_nk = w8.t().contiguous()
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[-1]
            whole = torch.randn((m, 2 * K), generator=g, device=dev)
            whole[:, 5::K // 3] *= 12.0             # emergent outliers in both halves
            whole = whole.to(dt)
            x, other = whole[:, :K].contiguous(), whole[:, K:]
            for form in ("pure", "outliers"):
                keep = addend = None
                if form == "outliers":
                    keep, addend = Q._outlier_split(
                        x, w8, ws, Q.QuantConfig(matmul=True, outlier_cols=8))
                own = x.float() if keep is None else x.float() * keep
                amax = torch.maximum(own.abs().amax(-1), other.float().abs().amax(-1))
                out = WF.w8a8(x, w8, ws, keep, addend, w_nk, amax)
                ref = WF.w8a8_plain(x, w8, ws, keep, addend, amax)
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"w8a8 row amax [{dn}] {name} {form}: {int((out != ref).sum())} "
                        f"elements differ, max abs "
                        f"{float((out.float() - ref.float()).abs().max()):.3e}")
                if torch.equal(out, WF.w8a8(x, w8, ws, keep, addend, w_nk)):
                    raise AssertionError(f"w8a8 row amax [{dn}] {name}: the supplied "
                                         "amax changed nothing")
            print(f"w8a8 row amax [{dn}] {name} m {m} K {K} N {N}: kernel == plain bit "
                  "for bit (pure, outliers)")
            if dt is not torch.bfloat16 or "(tp 4)" in name:
                continue
            x32 = x.float()
            xs = torch.clamp(amax[:, None], min=1e-8) * WF.INV_127
            x8 = torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8)
            w8_cm = w8.t().contiguous().t()
            w_deq = Q.dequantize_weight(q, dt)
            b_ms, b_by = bound(m * K * 2 + m * 4 + K * N + N * 4 + m * N * 2,
                               2 * m * K * N, "int8")
            t = {"shape": name, "m": m, "K": K, "N": N,
                 "ms": device_ms(lambda: WF.w8a8(x, w8, ws, None, None, w_nk, amax), 16),
                 "plain_ms": device_ms(lambda: WF.w8a8_plain(x, w8, ws, None, None, amax), 2),
                 "int_mm_ms": device_ms(lambda: torch._int_mm(x8, w8_cm), 16),
                 "bf16_matmul_ms": device_ms(lambda: torch.matmul(x, w_deq), 16),
                 "bound_ms": b_ms, "bound_by": b_by}
            timed.append(t)
            print(f"  w8a8 row amax [bfloat16] {name}: kernel {t['ms']:.4f} ms (device)  "
                  f"plain {t['plain_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
                  f"torch._int_mm {t['int_mm_ms']:.4f} ms  bf16 matmul (dequantized) "
                  f"{t['bf16_matmul_ms']:.4f} ms")
            del w_deq, x8
        torch.cuda.empty_cache()
    rows["w8a8"]["tp2_by_shape"] = timed

    Dh = TP_H * 64
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[-1]
        qe, ke, ve, do = (torch.randn((B, T_ENC, Dh), generator=g, device=dev).to(dt)
                          for _ in range(4))
        qc, doc = (torch.randn((B, CROSS_TQ, Dh), generator=g, device=dev).to(dt)
                   for _ in range(2))
        for shape, q, dout in (("self", qe, do), ("cross", qc, doc)):
            print(f"encoder_attention [{dn}] {TP_H} heads, {shape} Tq {q.shape[1]} Tk {T_ENC}:")
            compare("encoder_attention", EA.dense_attention_packed(q, ke, ve, 64, T_ENC),
                    EA.dense_attention_packed_plain(q, ke, ve, 64, T_ENC), dn)
            _, lse = EA._dense_attention_packed_cuda(q, ke, ve, 64, T_ENC, with_lse=True)
            compare("encoder_attention_bwd",
                    EA._dense_attention_packed_bwd_cuda(q, ke, ve, dout, lse, 64, T_ENC),
                    EA.dense_attention_packed_bwd_plain(q, ke, ve, dout, 64, T_ENC), dn)
        if dt is torch.bfloat16:
            hq, hk, hv = (a.view(B, T_ENC, TP_H, 64).transpose(1, 2) for a in (qe, ke, ve))
            _, lse = EA._dense_attention_packed_cuda(qe, ke, ve, 64, T_ENC, with_lse=True)
            hg = [a.detach().requires_grad_() for a in (hq, hk, hv)]
            oh = F.scaled_dot_product_attention(*hg)
            doh = do.view(B, T_ENC, TP_H, 64).transpose(1, 2)
            fwd_b = bound(4 * B * T_ENC * Dh * dt.itemsize, 4 * B * TP_H * T_ENC * T_ENC * 64, dn)
            bwd_b = bound(B * TP_H * 7 * T_ENC * 64 * dt.itemsize + B * TP_H * T_ENC * 4,
                          5 * 2 * B * TP_H * T_ENC * T_ENC * 64, dn)
            fwd = {"ms": device_ms(lambda: EA.dense_attention_packed(qe, ke, ve, 64, T_ENC), 8),
                   "plain_ms": device_ms(
                       lambda: EA.dense_attention_packed_plain(qe, ke, ve, 64, T_ENC), 2),
                   "library_ms": device_ms(lambda: F.scaled_dot_product_attention(hq, hk, hv), 8),
                   "bound_ms": fwd_b[0], "bound_by": fwd_b[1]}
            bwd = {"ms": device_ms(lambda: EA._dense_attention_packed_bwd_cuda(
                       qe, ke, ve, do, lse, 64, T_ENC), 8),
                   "plain_ms": device_ms(lambda: EA.dense_attention_packed_bwd_plain(
                       qe, ke, ve, do, 64, T_ENC), 2),
                   "library_ms": profiled_ms(lambda: torch.autograd.grad(
                       oh, hg, doh, retain_graph=True)),
                   "bound_ms": bwd_b[0], "bound_by": bwd_b[1]}
            rows["encoder_attention"].update({f"h10_{k}": v for k, v in fwd.items()})
            rows["encoder_attention_bwd"].update({f"h10_{k}": v for k, v in bwd.items()})
            for what, t in (("forward", fwd), ("backward", bwd)):
                print(f"  encoder_attention {what} [{dn}] {TP_H} heads self: kernel "
                      f"{t['ms']:.4f} ms (device)  plain {t['plain_ms']:.4f} ms  bound "
                      f"{t['bound_ms']:.4f} ms ({t['bound_by']})  SDPA {t['library_ms']:.4f} ms")
            del hg, oh, lse
        del qe, ke, ve, do, qc, doc
        qkv = torch.randn((B, T_ENC, 3 * Dh), generator=g, device=dev).to(dt)
        do = torch.randn((B, T_ENC, Dh), generator=g, device=dev).to(dt)
        print(f"encoder_attention_qkv [{dn}] {TP_H} heads, qkv ({B}, {T_ENC}, {3 * Dh}):")
        compare("encoder_attention_qkv", EA.dense_attention_qkv(qkv, 64),
                EA.dense_attention_qkv_plain(qkv, 64), dn)
        xg = qkv.detach().requires_grad_()
        (grad,) = torch.autograd.grad(EA.dense_attention_qkv(xg, 64), (xg,), do)
        compare("encoder_attention_qkv_bwd", grad,
                EA.dense_attention_qkv_bwd_plain(qkv, do, 64), dn)
        if dt is torch.bfloat16:
            heads = [t_.view(B, T_ENC, TP_H, 64).transpose(1, 2) for t_ in EA._qkv_views(qkv, 64)]
            t = {"ms": device_ms(lambda: EA.dense_attention_qkv(qkv, 64), 8),
                 "plain_ms": device_ms(lambda: EA.dense_attention_qkv_plain(qkv, 64), 2),
                 "library_ms": device_ms(lambda: F.scaled_dot_product_attention(*heads), 8),
                 "bound_ms": fwd_b[0], "bound_by": fwd_b[1]}
            rows["encoder_attention_qkv"].update({f"h10_{k}": v for k, v in t.items()})
            print(f"  encoder_attention_qkv [{dn}] {TP_H} heads: kernel {t['ms']:.4f} ms "
                  f"(device)  plain {t['plain_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']})  SDPA {t['library_ms']:.4f} ms")
            del heads
        del qkv, do, xg, grad
        torch.cuda.empty_cache()


def cuda_events(fn, calls: int = 4) -> dict:
    """Launches per call of every CUDA kernel, copy and memset of fn(), by
    name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {name: n for _, n, name in kernel_times(prof, calls)}


def check_log_mel(rows):
    """Phase 3f: the log-mel kernel (fp32 on the CUDA cores: the 200-point
    FFT in shared memory, the filters' band sums, the floor in the same call)
    against its plain version at B 4 over 30 s of seeded noise (one
    utterance part silence), 80 and 128 mel bins: the normalized output
    within the fp32 limits, two calls bit-equal, the CUDA kernels a call
    launches asserted (log_mel_kernel and log_mel_floor_kernel, no copy).
    At 128 (large-v3's), by CUDA-graph replay: the function, the kernel's
    raw output, the plain version, and two yardsticks the port never
    calls, the production conv form ops/logmel.log_mel_spectrogram (its
    tables resident: the profiler shows it no copy) and torch.stft (cuFFT)
    with power, the mel product, log10 and the floor
    (tools/bench_log_mel.stft_log_mel); the bound from the audio in, the
    output out and the fast transform's operations (flops_per_frame); and,
    on a tonal input (a few sinusoids, a quiet tail), the largest error of
    the kernel and of the plain version against the function in float64."""
    import torch
    from asr_finetune_tpu_torch.ops import logmel as LM
    from asr_finetune_tpu_torch.ops import logmel_fused as LF
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    from bench_log_mel import log_mel_f64, stft_log_mel, tonal_audio

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
        same_bits("log_mel", out, LF.log_mel_fused(audio, n_mels))
        events = cuda_events(lambda: LF.log_mel_fused(audio, n_mels))
        kernels = {k: sorted(n for name, n in events.items() if f"::{k}(" in name)
                   for k in ("log_mel_kernel", "log_mel_floor_kernel")}
        print(f"  CUDA launches a call: {events}")
        if len(events) != 2 or kernels != {"log_mel_kernel": [1.0],
                                           "log_mel_floor_kernel": [1.0]}:
            raise AssertionError(f"log_mel: CUDA launches a call {events}")
        if n_mels == 128:
            conv = cuda_events(lambda: LM.log_mel_spectrogram(audio, n_mels))
            print(f"  conv form's CUDA launches a call: {conv}")
            if any("Memcpy" in name for name in conv):
                raise AssertionError(f"log_mel: the conv form copies its tables: {conv}")
            window = torch.hann_window(400, periodic=True, dtype=torch.float64).float().to(dev)
            melfb = LM.device_tables(n_mels, dev)[1]
            tone = tonal_audio(B, dev)
            f64 = log_mel_f64(tone, n_mels)
            tonal = {"kernel": float((LF.log_mel_fused(tone, n_mels) - f64).abs().max()),
                     "plain": float((LF.log_mel_fused_plain(tone, n_mels) - f64).abs().max())}
            print(f"  tonal input, largest error against float64: kernel {tonal['kernel']:.3e}, "
                  f"plain {tonal['plain']:.3e}")
            del tone, f64
            b_ms, b_by = bound(nbytes(audio, out),
                               B * LM.NUM_FRAMES * LF.flops_per_frame(n_mels), "float32")
            r = rows["log_mel"] = {
                "name": "log_mel", "route": "cuda", "source": SOURCES["log_mel"],
                "replaces": REPLACES["log_mel"], "launches": 0, "max_abs_err": err[0],
                "rms_rel_err": err[1], "cuda_launches_a_call": events,
                "timed_by": "CUDA-graph replay",
                "ms": device_ms(lambda: LF.log_mel_fused(audio, n_mels), 16),
                "raw_ms": device_ms(lambda: LF._log10_mel_cuda(audio, n_mels), 16),
                "plain_ms": device_ms(lambda: LF.log_mel_fused_plain(audio, n_mels), 16),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": device_ms(lambda: LM.log_mel_spectrogram(audio, n_mels), 16),
                "library_stft_ms": device_ms(lambda: stft_log_mel(audio, window, melfb), 16),
                "tonal_f64_err": tonal}
            print(f"  log_mel [float32] {n_mels} mels: function {r['ms']:.4f} ms (device, "
                  f"graph replay; the kernel's raw output {r['raw_ms']:.4f} ms)  plain "
                  f"{r['plain_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})  conv form "
                  f"{r['library_ms']:.4f} ms  torch.stft form {r['library_stft_ms']:.4f} ms  "
                  f"({card_line()})")
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
    from asr_finetune_tpu_torch.ops import decoder_fused as DF

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
        # a[2]: the position, an int through the host, a tensor on the card
        # inside the greedy graph's capture (no sync there)
        if stats["steps"] == 0 or (isinstance(a[2], int) and a[2] == 0):
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
        DF.reset_kernel_launches()
        decode_lib.reset_graph_counters()
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
        cuda_kernels = DF.kernel_launches()
        # greedy replays its graph past the first free position: a capture
        # calls the step once and runs nothing, each replay runs a position
        graph = decode_lib.graph_counters()
        stats["steps"] += graph["replays"] - graph["captures"]
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
    label = f"main path {path}"
    check_decoder_cuda_kernels(label, cuda_kernels)
    record_launches(rows, path, launches)
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
    a finite WER) and that the resumed run decoded only the second batch.
    Returns eval_final.json's content (phase 10 reads it)."""
    import torch
    from asr_finetune_tpu_torch import config as config_lib
    from asr_finetune_tpu_torch import run as run_lib
    from asr_finetune_tpu_torch.data.audiofolder import read_wav
    from asr_finetune_tpu_torch.data.collator import Collator, CollatorConfig
    from asr_finetune_tpu_torch.evaluation.evaluate import EvalConfig, OfflineEvaluator
    from asr_finetune_tpu_torch.ops import decoder_fused as DF

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
        DF.reset_kernel_launches()
        t0 = time.perf_counter()
        OfflineEvaluator(built.cfg, built.params, built.tokenizer, cfg).run(batches[:1])
        first = all_launches()
        reset_all_launches()
        final = OfflineEvaluator(built.cfg, built.params, built.tokenizer, cfg).run(batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        second = all_launches()
        cuda_kernels = DF.kernel_launches()
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
    check_decoder_cuda_kernels(f"offline evaluator, beam-{BEAMS}", cuda_kernels)
    launches = {k: first[k] + second[k] for k in first}
    record_launches(rows, f"evaluate_beam{BEAMS}", launches)
    print(f"offline evaluator, beam-{BEAMS}, large-v3 32+32 bf16: 4 utterances in 2 batches "
          f"(run stopped after batch 1, resumed at batch 2), corpus WER {final['wer']:.2f}%, "
          f"{wall:.3f} s for both runs; launches {json.dumps({k: v for k, v in launches.items() if v})}")
    return on_disk


def check_decoder_cuda_kernels(label: str, counts: dict) -> None:
    """A bf16 decode path's CUDA kernel launches (DF.kernel_launches) over
    decode steps of at most 32 rows: per layer one pass of qkv, of the cross
    q product, of fc1 and of fc2, and two of the attention core and of wo
    (the cross-attention's and the self or beam self-attention's); no GEMV,
    partial or combine kernel, which only fp32 calls launch."""
    n = counts["qkv_kernel"]
    want = {**counts, "gemv_kernel": 0, "attn_partial_kernel": 0, "attn_combine_kernel": 0,
            "mlp_fc1_kernel": n, "mlp_fc2_kernel": n, "attn_q_kernel": n,
            "attn_chunk_kernel": 2 * n, "attn_wo_kernel": 2 * n}
    if n == 0 or counts != want:
        raise AssertionError(f"{label}: CUDA kernel launches {counts}, expected {want}")
    print(f"{label}: CUDA kernel launches {json.dumps({k: v for k, v in counts.items() if v})}")


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
    Q.w8a8 = lambda x, w, sc, keep=None, addend=None, w_nk=None, row_amax=None: \
        WF.w8a8_plain(x, w, sc, keep, addend, row_amax)
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


# device ms of step 4 by training path: attention forward and backward, W8A8, all
# kernels, and the step's end-to-end ms (printed as one JSON line)
STEP_DEVICE: dict = {}
# ms/step (steps 2-3) and peak device memory by training path, for phase 8
TRAIN_READINGS: dict = {}
ATTN_BWD = "attention backward (enc_attn_bwd_di/dkdv_wgmma, dq_store)"
ATTN_FWD = "attention forward (enc_attn_fwd_*)"
W8A8 = "W8A8 (quantize_rows, w8a8_wgmma)"


def kernel_category(name: str) -> str:
    low = name.lower()
    if "enc_attn_bwd" in low:
        return ATTN_BWD
    if "enc_attn_fwd" in low:
        return ATTN_FWD
    if "w8a8" in low or "quantize_rows" in low:
        return W8A8
    if any(s in low for s in ("gemv_kernel", "attn_partial", "attn_combine", "mlp_fc",
                              "attn_q_kernel", "attn_chunk", "attn_wo", "qkv_kernel")):
        return "decoder kernels (gemv, attn_partial/combine, mlp_fc1/fc2, attn_q/chunk/wo, qkv)"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_")):
        return "matrix products (cuBLAS)"
    if "multi_tensor" in low or "foreach" in low:
        return "foreach (optimizer, norms)"
    if "conv" in low or "cudnn" in low:
        return "conv stem (cuDNN)"
    return "elementwise, reductions, copies"


def train_w8a8_launches(n_enc: int, n_dec: int, fused_qkv: bool, save: str) -> tuple:
    """(forward, recompute): the W8A8 launches of a train step's forward
    and of its backward's recompute, under remat save mode `save`. A forward
    runs each frozen product once: q, k, v (or the wide q|k|v), o, fc1, fc2
    of an encoder layer, the self- and cross-attention's q, k, v, o and
    fc1, fc2 of a decoder layer. "mid" recomputes them all; where a stack's
    save points are kept ("enc": the encoder, "enc+dec": both) the backward
    recomputes only the output projections and fc2 (the q/k/v and fc1
    outputs are kept)."""
    enc = (4 if fused_qkv else 6) * n_enc
    dec = 10 * n_dec
    return enc + dec, ((2 * n_enc if save != "mid" else enc)
                       + (3 * n_dec if save == "enc+dec" else dec))


def train_main_path(rows, device: str = "cuda", model: str = "large-v3",
                    extra=(), config: str = TRAIN_CONFIG, fused_qkv: bool = False,
                    batch: int = B, path: str = "", label: str = ""):
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
    merged base is mixed int8/float and keeps the three projections.

    Phases 9a and 9b are the same function with more flags (`batch` the
    rows a step, `path` the launch column, `label` the printed name): it
    also counts the SpecAugment draws (one a step with --spec_augment, none
    in the eval), times the collator's batches in the prefetch thread (with
    --host_logmel the host log-mel) and the trainer's wait for each batch,
    and keeps the step-1 loss and the calibrated columns for comparison.
    Every run keeps the remat save mode of ASR_TPU_REMAT_SAVE (default
    enc+dec), which the W8A8 count follows (`train_w8a8_launches`)."""
    import os
    import shutil
    import torch
    from torch.profiler import ProfilerActivity, profile
    from asr_finetune_tpu_torch import run as run_lib
    from asr_finetune_tpu_torch.cli import train as train_cli
    from asr_finetune_tpu_torch.data import collator as collator_lib
    from asr_finetune_tpu_torch.evaluation import decode as decode_lib
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.ops import quant as Q
    from asr_finetune_tpu_torch.training import checkpoint as ckpt_lib
    from asr_finetune_tpu_torch.training import train_step as TS
    from asr_finetune_tpu_torch.training import trainer as trainer_lib

    on_card = device == "cuda"
    peft = config == PEFT_CONFIG
    int8_matmul = "--int8_matmul" in extra
    spec_augment = "--spec_augment" in extra
    host_logmel = "--host_logmel" in extra
    remat_mode = W.remat_save()
    tag = next(line.split("=", 1)[1].strip() for line in open(config)
               if line.startswith("output_tag"))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    st = {"steps": [], "evals": 0, "dec_steps": 0, "saves": [], "eval_s": 0.0,
          "calib": None, "outliers": {}, "draws": 0, "collate": [], "waits": []}
    orig = (trainer_lib.make_train_step, trainer_lib.make_eval_loss_step,
            W.decode_step_fused, ckpt_lib.CheckpointManager.save,
            trainer_lib.Trainer.evaluate, run_lib.calibrate_outliers, Q._outlier_split,
            TS.spec_augment_stream, collator_lib.Collator.__call__, run_lib.device_prefetch)

    def spec_augment_stream(*a, **k):
        st["draws"] += 1
        return orig[7](*a, **k)

    def collate(self, rows_):
        t0 = time.perf_counter()
        out = orig[8](self, rows_)
        st["collate"].append((time.perf_counter() - t0, len(rows_), "mel" in out))
        return out

    def device_prefetch(*a, **k):
        """The trainer's wait for each batch: ~0 while the prefetch thread
        keeps ahead of the steps."""
        it = orig[9](*a, **k)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                st["waits"].append(time.perf_counter() - t0)
                yield b
        finally:
            it.close()

    def outlier_split(x, w_q8, w_scale, cfg, row_split=False):
        """Counts the W8A8 products by (d_in, d_out) class and outlier form."""
        klass = Q.logical_class(x.shape[-1], w_q8.shape[-1], row_split)
        static = cfg.static_idx is not None and klass in cfg.static_idx
        key = (klass, "calibrated" if static else "dynamic top-k")
        st["outliers"][key] = st["outliers"].get(key, 0) + 1
        return orig[6](x, w_q8, w_scale, cfg, row_split)

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
         trainer_lib.Trainer.evaluate, run_lib.calibrate_outliers, Q._outlier_split,
         TS.spec_augment_stream, collator_lib.Collator.__call__, run_lib.device_prefetch) = (
            make_train_step, make_eval_loss_step, decode_step_fused, save, evaluate,
            calibrate_outliers, outlier_split, spec_augment_stream, collate, device_prefetch)
        if fused_qkv:
            os.environ["ASR_TPU_FUSED_QKV"] = "1"
        reset_all_launches()
        decode_lib.reset_graph_counters()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            result = train_cli.main(argv)
        finally:
            (trainer_lib.make_train_step, trainer_lib.make_eval_loss_step,
             W.decode_step_fused, ckpt_lib.CheckpointManager.save,
             trainer_lib.Trainer.evaluate, run_lib.calibrate_outliers,
             Q._outlier_split, TS.spec_augment_stream, collator_lib.Collator.__call__,
             run_lib.device_prefetch) = orig
            os.environ.pop("ASR_TPU_FUSED_QKV", None)
        sync()
        wall = time.perf_counter() - t0
        # the eval's greedy decode replays its graph: a capture calls the
        # step once and runs nothing, each replay runs a position
        graph = decode_lib.graph_counters()
        st["dec_steps"] += graph["replays"] - graph["captures"]
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
    label = label or ("PEFT main path" if peft else "train main path") + (
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
    if any(s["shape"] != (batch, CROSS_TQ) for s in steps):
        raise AssertionError(f"labels not at batch {batch} x the {CROSS_TQ} bucket")
    if st["draws"] != (TRAIN_STEPS if spec_augment else 0):
        raise AssertionError(f"{st['draws']} SpecAugment draws in {TRAIN_STEPS} steps "
                             f"(--spec_augment {spec_augment}); the eval draws none")
    if not st["collate"] or any(f != host_logmel for _, _, f in st["collate"]):
        raise AssertionError(f"collated batches carry mel {[f for _, _, f in st['collate']]}"
                             f", expected {host_logmel} (--host_logmel)")
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
    #
    # Under the save points ("enc", "enc+dec") the backward recomputes the
    # attention forward (and so launches it again) but not the kept
    # products: `train_w8a8_launches`.
    mm = 6 * n_enc + 10 * n_dec
    mm_step, mm_re = train_w8a8_launches(n_enc, n_dec, fused_qkv, remat_mode)
    calibrated = int(st["calib"] is not None)
    dec = {k + ("_int8" if peft else ""): n_dec * st["dec_steps"] for k in DECODER}
    step_fwd = TRAIN_STEPS * 2 + st["evals"]        # training forwards, remat included
    enc_fwd = dict(encoder_attention_qkv=step_fwd * n_enc,
                   encoder_attention_qkv_bwd=TRAIN_STEPS * n_enc) if fused_qkv else {}
    expect = expect_launches(
        encoder_attention=(step_fwd * (0 if fused_qkv else n_enc) + step_fwd * n_dec
                           + calibrated * (n_enc + n_dec) + st["evals"] * n_enc),
        encoder_attention_bwd=TRAIN_STEPS * ((0 if fused_qkv else n_enc) + n_dec),
        w8a8=(mm_step * (TRAIN_STEPS + st["evals"]) + mm_re * TRAIN_STEPS
              + mm * calibrated + st["evals"] * (4 * n_enc + n_dec)
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
        n_wide = (TRAIN_STEPS * (2 if remat_mode == "mid" else 1) + st["evals"]) * n_enc
        if st["outliers"].get(wide, 0) != (n_wide if fused_qkv else 0):
            raise AssertionError(f"wide products in the dynamic form: "
                                 f"{st['outliers'].get(wide, 0)} != {n_wide}")
    record_launches(rows, path or ("peft" if peft else "train")
                    + ("_fused_qkv" if fused_qkv else ""), launches)
    step_s = float(np.mean([s["s"] for s in steps[1:-1]]))
    usage = np.mean([s["usage"] for s in steps[1:-1]], axis=0)
    tokens = float(np.mean([s["tokens"] for s in steps[1:-1]]))
    save_step, save_s, save_bytes = st["saves"][0]
    if st["calib"] is not None:
        print(f"{label}: calibrated outlier columns per (d_in, d_out) class: "
              + ", ".join(f"{k}: {len(v)} {list(v)}" for k, v in sorted(st["calib"].items())))
    TRAIN_READINGS[label] = {"step_ms": 1e3 * step_s, "peak_gib": peak / 2**30,
                             "loss1": steps[0]["loss"],
                             "calib": {f"{k[0]} x {k[1]}": [int(i) for i in v]
                                       for k, v in (st["calib"] or {}).items()}}
    coll = [1e3 * t for t, n, _ in st["collate"] if n == batch]
    print(f"{label}: remat saves {remat_mode}; {st['draws']} SpecAugment draws; collator "
          f"({'host log-mel' if host_logmel else 'raw audio'}) {np.mean(coll):.1f} ms a "
          f"batch of {batch} in the prefetch thread (min {min(coll):.1f}, max "
          f"{max(coll):.1f}, {len(coll)} batches); the trainer waited "
          f"{', '.join(f'{1e3 * w:.1f}' for w in st['waits'])} ms for its batches")
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
        af, ab = cats.get(ATTN_FWD, [0.0, 0]), cats.get(ATTN_BWD, [0.0, 0])
        w8 = cats.get(W8A8, [0.0, 0])
        print(f"{label}, step 4: attention forward {af[0]:.3f} ms ({af[1]} launches), "
              f"attention backward {ab[0]:.3f} ms ({ab[1]} launches), "
              f"W8A8 {w8[0]:.3f} ms ({w8[1]} launches) of {busy:.3f} ms device time; "
              f"{1e3 * step_s:.3f} ms/step, device idle {100 * (1 - busy / (1e3 * step_s)):.1f}%")
        STEP_DEVICE[label] = {"attention_fwd_ms": af[0], "attention_bwd_ms": ab[0],
                              "w8a8_ms": w8[0], "busy_ms": busy, "step_ms": 1e3 * step_s}
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


# Phase 7c, the HPO main path: 3 trials of large-v3 PEFT over the int8 base
HPO_TRIALS = 3
# device memory a finished trial may leave allocated beyond what the process
# held before the first trial: the kernels' workspaces and the log-mel
# tables are made once per device and kept, a trial's model and state are
# gigabytes
HPO_MEM_MARGIN = 256 * 2 ** 20
# the kernels every trial must launch: W8A8, the encoder-attention forward
# and backward, and the int8 / mixed-weight option of each decoder kernel
# (the eval decode over the merged base)
HPO_KERNELS = ("w8a8", "encoder_attention", "encoder_attention_bwd",
               *(k + "_int8" for k in DECODER))


def write_hf_dir(path, seed: int = 0) -> dict:
    """An HF-layout Whisper checkpoint directory at whisper-tiny's widths
    and depth (d 384, 6 heads of 64, ff 1536, 4 + 4 layers, vocab 51865):
    config.json and a pytorch_model.bin written by torch.save, the weights
    random from `seed`, under the names WhisperForConditionalGeneration's
    state_dict uses. No transformers needed. Returns the config."""
    import torch
    d, heads, ff, layers, vocab, n_mels, src, tgt = 384, 6, 1536, 4, 51865, 80, 1500, 448
    cfg = {"vocab_size": vocab, "num_mel_bins": n_mels, "d_model": d,
           "encoder_layers": layers, "decoder_layers": layers,
           "encoder_attention_heads": heads, "decoder_attention_heads": heads,
           "encoder_ffn_dim": ff, "decoder_ffn_dim": ff, "max_source_positions": src,
           "max_target_positions": tgt, "pad_token_id": 50257, "bos_token_id": 50257,
           "eos_token_id": 50257, "decoder_start_token_id": 50258}
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g) * 0.02

    def ln(name):
        sd[name + ".weight"], sd[name + ".bias"] = 1.0 + r(d), r(d)

    sd = {"model.encoder.conv1.weight": r(d, n_mels, 3), "model.encoder.conv1.bias": r(d),
          "model.encoder.conv2.weight": r(d, d, 3), "model.encoder.conv2.bias": r(d),
          "model.encoder.embed_positions.weight": r(src, d),
          "model.decoder.embed_tokens.weight": r(vocab, d),
          "model.decoder.embed_positions.weight": r(tgt, d)}
    for side in ("encoder", "decoder"):
        for i in range(layers):
            p = f"model.{side}.layers.{i}"
            for blk in ("self_attn",) + (("encoder_attn",) if side == "decoder" else ()):
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    sd[f"{p}.{blk}.{proj}.weight"] = r(d, d)
                    if proj != "k_proj":
                        sd[f"{p}.{blk}.{proj}.bias"] = r(d)
                ln(f"{p}.{blk}_layer_norm")
            sd[f"{p}.fc1.weight"], sd[f"{p}.fc1.bias"] = r(ff, d), r(ff)
            sd[f"{p}.fc2.weight"], sd[f"{p}.fc2.bias"] = r(d, ff), r(d)
            ln(f"{p}.final_layer_norm")
        ln(f"model.{side}.layer_norm")
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    return cfg


def hpo_main_path(rows, device: str = "cuda", model: str = "large-v3",
                  trials: int = HPO_TRIALS):
    """Phase 7c, the HPO main path and the deployment half:
    `asr_finetune_tpu_torch.cli.train_hyper` with the repo's
    largev3_peft_debug.config and --int8_matmul: TPE search
    (large_small_OPTUNA, the production searcher) over learning_rate, the
    AdaLoRA rank and alpha, with ASHA (grace period 2), `trials` trials of
    whisper-large-v3 at full width and depth over the int8 base, each 4
    steps of batch 4 with an eval (loss + WER of the decode through the
    decoder kernels' int8 and mixed options) and a checkpoint every 2, on
    the 20 seeded wavs of phase 6. Prints one line per trial (hp, status,
    final step, ASHA decisions, wall, ms/step, peak memory, launches) and
    asserts: no trial errored; best_result.json names a trial; every trial
    launched W8A8, the encoder-attention forward and backward and the int8
    decoder kernels; after each trial the device memory allocated is back
    within HPO_MEM_MARGIN of its value before the first. Then:
    --resume_training runs no trial, launches no kernel and names the same
    best trial; `cli.export` of the best trial's checkpoints (merged: q/v
    fp32, the rest int8, no K-major copy) reloads, and `cli.transcribe
    --model_path <export>` (fp32) decodes four of the wavs through the
    decoder kernels' int8 options, its tokens equal to the plain decode of
    the same merged tree on the same device; `cli.prepare_model --verify`
    converts a whisper-tiny-shaped HF directory and runs its forward on the
    device. `device` and `model` let the same function run a small model
    on the CPU."""
    import glob
    import torch
    from asr_finetune_tpu_torch import run as run_lib
    from asr_finetune_tpu_torch.cli import export as export_cli
    from asr_finetune_tpu_torch.cli import prepare_model, train_hyper, transcribe
    from asr_finetune_tpu_torch.evaluation import decode as decode_lib
    from asr_finetune_tpu_torch.hpo import schedulers as sched_lib
    from asr_finetune_tpu_torch.models import native_io
    from asr_finetune_tpu_torch.ops import quant as Q
    from asr_finetune_tpu_torch.training import trainer as trainer_lib
    from asr_finetune_tpu_torch.training.optim import leaves

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def allocated() -> int:
        return torch.cuda.memory_allocated() if on_card else 0

    tag = next(line.split("=", 1)[1].strip() for line in open(PEFT_CONFIG)
               if line.startswith("output_tag"))
    runs, decisions, step_s, decodes = [], {}, [], []
    orig = (run_lib.run_trial, sched_lib.AshaScheduler.on_result,
            trainer_lib.make_train_step, decode_lib.greedy_decode)

    def on_result(self, trial_id, step, metrics):
        go = orig[1](self, trial_id, step, metrics)
        decisions.setdefault(trial_id, []).append(f"step {step} {'go on' if go else 'stop'}")
        return go

    def make_train_step(*a, **k):
        inner = orig[2](*a, **k)

        def step(state, batch):
            sync()
            t0 = time.perf_counter()
            m = inner(state, batch)
            sync()
            step_s.append(time.perf_counter() - t0)
            return m
        return step

    def run_trial(args, hp=None, trial_dir=None, **k):
        sync()
        before, n_steps = all_launches(), len(step_s)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            return orig[0](args, hp, trial_dir, **k)
        finally:
            sync()
            after = all_launches()
            runs.append({"trial": os.path.basename(trial_dir), "hp": hp,
                         "wall": time.perf_counter() - t0, "steps": step_s[n_steps:],
                         "peak": torch.cuda.max_memory_allocated() if on_card else 0,
                         "allocated": allocated(),
                         "launches": {n: after[n] - before[n] for n in after}})

    def greedy_decode(params, mel, *a, **k):
        out = orig[3](params, mel, *a, **k)
        decodes.append((params, mel, a, k, out[0].clone()))
        return out

    def patch(on: bool):
        (run_lib.run_trial, sched_lib.AshaScheduler.on_result,
         trainer_lib.make_train_step) = ((run_trial, on_result, make_train_step)
                                         if on else orig[:3])

    with tempfile.TemporaryDirectory() as tmp:
        data = f"{tmp}/data"
        os.makedirs(data)
        write_audiofolder(data, TRAIN_UTTS)
        argv = ["-c", PEFT_CONFIG, "--model_type", model, "--device", device, "--no-debug",
                "--int8_matmul", "--data_mode", "folder", "--dataset_name", data,
                "--val_split", "0.2", "--search_schedule_mode", "large_small_OPTUNA",
                "--num_samples", str(trials), "--max_steps", str(TRAIN_STEPS),
                "--eval_steps", "2", "--save_steps", "2", "--grace_period", "2",
                "--logging_steps", "2", "--eval_sample_fraction", "1.0",
                "--generation_max_length", str(TRAIN_GEN_LEN), "--wer_weight", "0.7",
                "--storage_path", f"{tmp}/hpo"]
        sync()
        base = allocated()
        reset_all_launches()
        patch(True)
        t0 = time.perf_counter()
        try:
            summary = train_hyper.main(argv)
        finally:
            patch(False)
        wall = time.perf_counter() - t0
        launches = all_launches()
        exp = f"{tmp}/hpo/{tag}"
        with open(f"{exp}/experiment_state.json") as f:
            state = json.load(f)["trials"]
        with open(f"{exp}/best_result.json") as f:
            best = json.load(f)

        label = "HPO main path"
        print(f"{label}: cli.train_hyper -c {PEFT_CONFIG} --int8_matmul, {model}, "
              f"TPE + ASHA, {trials} trials of {TRAIN_STEPS} steps, wall {wall:.3f} s; "
              f"best {json.dumps(summary, default=str)}")
        for r in runs:
            rec = state[r["trial"]]
            s = r["steps"]
            ms = 1e3 * float(np.mean(s[1:]))
            print(f"  {r['trial']}: hp {json.dumps(r['hp'])} status {rec['status']} final step "
                  f"{rec.get('result', {}).get('final_step')} ASHA "
                  f"{', '.join(decisions.get(r['trial'], [])) or 'no rung'}; wall "
                  f"{r['wall']:.3f} s, {ms:.3f} ms/step (steps 2-{len(s)}), peak "
                  f"{r['peak'] / 2**30:.2f} GiB, allocated after {r['allocated'] / 2**20:.1f} "
                  f"MiB ({(r['allocated'] - base) / 2**20:+.1f} MiB on the start); launches "
                  f"{json.dumps({k: v for k, v in r['launches'].items() if v})}")
        if sorted(state) != [f"trial_{i:04d}" for i in range(trials)] or any(
                rec["status"] != "completed" for rec in state.values()):
            raise AssertionError(f"{label}: a trial did not complete: "
                                 f"{ {k: v['status'] for k, v in state.items()} }")
        if best["best_trial"] not in state or summary["best_trial"] != best["best_trial"]:
            raise AssertionError(f"{label}: best_result.json names no trial: {best}")
        if len(runs) != trials or len(step_s) < trials * 2:
            raise AssertionError(f"{label}: {len(runs)} trials ran, {len(step_s)} steps")
        for r in runs:
            silent = [k for k in HPO_KERNELS if r["launches"][k] == 0]
            if silent:
                raise AssertionError(f"{label}: {r['trial']} launched no {silent}")
            if r["allocated"] - base > HPO_MEM_MARGIN:
                raise AssertionError(
                    f"{label}: {r['trial']} left {(r['allocated'] - base) / 2**20:.1f} MiB "
                    f"allocated (margin {HPO_MEM_MARGIN / 2**20:.0f} MiB)")
        record_launches(rows, "train_hyper", launches)
        print(f"{label}: launches {json.dumps({k: v for k, v in launches.items() if v})}")

        # resume: every trial completed, so nothing runs
        reset_all_launches()
        n_runs = len(runs)
        patch(True)
        try:
            again = train_hyper.main(argv + ["--resume_training"])
        finally:
            patch(False)
        rerun = {k: v for k, v in all_launches().items() if v}
        if again["best_trial"] != summary["best_trial"] or len(runs) != n_runs or rerun:
            raise AssertionError(f"{label} resumed: best {again['best_trial']} (was "
                                 f"{summary['best_trial']}), {len(runs) - n_runs} trials "
                                 f"run, launches {rerun}")
        print(f"{label} resumed: best {again['best_trial']}, no trial run, no launch")

        # export the best trial, merged, then serve it
        out = f"{tmp}/export"
        sync()
        t0 = time.perf_counter()
        export_cli.main(["--checkpoint_dir", f"{exp}/{best['best_trial']}/checkpoints",
                         "--export_dir", out, "-c", PEFT_CONFIG, "--model_type", model,
                         "--device", device, "--no-debug"])
        export_s = time.perf_counter() - t0
        npz = f"{out}/params.npz"
        with np.load(npz) as z:
            kinds = {k: z[k].dtype.name for k in z.files}
        reloaded, _ = native_io.load_params(out, device)
        n_reloaded = len(leaves(reloaded))
        del reloaded
        q, k = ("decoder/layers/self_attn/q/", "decoder/layers/self_attn/k/")
        if any(Q.KMAJOR_KEY in name for name in kinds) or n_reloaded != len(kinds) \
                or kinds.get(q + "w") != "float32" or kinds.get(k + "w_q8") != "int8":
            raise AssertionError(f"{label}: export leaves {kinds}")
        print(f"{label}: cli.export of {best['best_trial']} (rank "
              f"{best['hp'].get('rank')}): {len(kinds)} leaves, "
              f"{sum(1 for v in kinds.values() if v == 'int8')} int8, "
              f"{os.path.getsize(npz) / 1e9:.3f} GB in {export_s:.3f} s, no K-major copy")

        wavs = sorted(glob.glob(f"{data}/*.wav"))[:B]
        reset_all_launches()
        decode_lib.greedy_decode = greedy_decode
        try:
            results = transcribe.main([
                "--model_path", out, "--inputs", *wavs, "--device", device, "--no-bf16",
                "--per_device_eval_batch_size", str(B),
                "--generation_max_length", str(TRAIN_GEN_LEN)])
        finally:
            decode_lib.greedy_decode = orig[3]
        served = all_launches()
        silent = [n for n in HPO_KERNELS[3:] if served[n] == 0]
        if len(results) != len(wavs) or len(decodes) != 1 or silent:
            raise AssertionError(f"{label}: transcribe --model_path export: {len(results)} "
                                 f"transcripts, {len(decodes)} decodes, launched no {silent}")
        params, mel, a, kw, tokens = decodes.pop()
        plain = orig[3](params, mel, *a, **{**kw, "fused": False})[0]
        del params, mel
        if not torch.equal(plain.cpu(), tokens.cpu()):
            raise AssertionError(f"{label}: the export's fused decode differs from the plain "
                                 f"one:\n{tokens.tolist()}\n{plain.tolist()}")
        print(f"{label}: cli.transcribe --model_path export (fp32, mixed int8 base): "
              f"{len(results)} wavs, tokens {tuple(tokens.shape)} equal the plain decode's; "
              f"launches {json.dumps({k: v for k, v in served.items() if v})}")

    with tempfile.TemporaryDirectory() as tmp:
        write_hf_dir(f"{tmp}/hf")
        reset_all_launches()
        prepare_model.main(["--hf_dir", f"{tmp}/hf", "--output", f"{tmp}/native",
                            "--verify", "--device", device])
        prepared = {k: v for k, v in all_launches().items() if v}
        if not prepared.get("encoder_attention"):
            raise AssertionError(f"prepare_model --verify launched {prepared}")
        print(f"prepare_model --verify (whisper-tiny shapes, pytorch_model.bin) on {device}: "
              f"launches {json.dumps(prepared)}")
    if on_card:
        torch.cuda.empty_cache()


# Phase 8, data parallelism and offload (asr_finetune_tpu_torch/parallel/)
DP_RANKS, DP_STEPS, DP_BATCH = 2, 4, 2          # 8a: 2 ranks x 2 rows = global batch 4
OFFLOAD_STEPS = 3                               # 8b, 8c
DP_TIMEOUT = 900                                # s, each rank process of 8a
# 8a, two ranks against one process at the global batch: the largest reading
# over the steps of |a - b| / |b| for the loss and grad_norm, and for the
# adapters after 4 steps RMS(a - b) / RMS(b - initial), over every adapter
# element: the gap against the update itself. The two runs compute each row
# alike; only sums across rows run in another order (a product of 2 x 1500
# rows against 4 x 1500 may take another cuBLAS split of its fp32 sums, the
# loss and gradients add two ranks' partial sums) and reach bf16 operands,
# where one rounding flip moves a value 2^-8. Adam then moves an element by
# ~lr whatever its gradient's size, so an element whose gradient is near 0
# may step the other way: the largest element gap is up to 2 lr a step (it
# is printed, not limited), while a fault (a rank's own gradients, the mean
# of the ranks' means) moves the RMS of the gap towards that of the update.
# The first reading on an H100 (PERF.md): loss 9.6e-5, grad_norm 9.2e-5,
# adapters 1.39e-2 (the largest element gap 1.33 x the largest update);
# limits ~10x the first two (the attention backward's dq also varies run to
# run) and ~4x the third.
DP_LIMITS = {"loss": 1e-3, "grad_norm": 1e-3, "adapters": 6e-2}
# 8c: device memory allocated after an offloaded step beyond its value before it
OFFLOAD_MEM_MARGIN = 8 * 2 ** 20


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dp_argv(data, out, batch, device, model, *extra):
    """largev3_peft_debug.config with --int8_matmul on the 20 wavs of phase
    6: `batch` rows a rank, eval batch 4 (a rank's share: 4 / world) with the
    greedy WER at steps 2 and 4, a checkpoint at step 4."""
    return ["-c", PEFT_CONFIG, "--model_type", model, "--device", device, "--no-debug",
            "--int8_matmul", "--data_mode", "folder", "--dataset_name", data,
            "--val_split", "0.2", "--per_device_train_batch_size", str(batch),
            "--per_device_eval_batch_size", str(B), "--max_steps", str(DP_STEPS),
            "--eval_steps", "2", "--save_steps", str(DP_STEPS), "--logging_steps", "2",
            "--eval_sample_fraction", "1.0", "--generation_max_length", str(TRAIN_GEN_LEN),
            "--wer_weight", "0.7", "--output_dir", out, *extra]


def _recorded_run(argv, sampler=None):
    """cli.train.main(argv) with its steps, sampled batches and evals
    recorded; `sampler` replaces the train stream's index batches. Returns
    (result, record): per step loss, grad_norm, tokens and seconds, the
    index batches the sampler yielded, (step, metrics) of each eval, the
    state after the last step and (PEFT) the adapters before the first."""
    import torch
    from asr_finetune_tpu_torch.cli import train as train_cli
    from asr_finetune_tpu_torch.data import pipeline as pipe_lib
    from asr_finetune_tpu_torch.training import trainer as trainer_lib
    from asr_finetune_tpu_torch.training.optim import leaves

    rec = {"steps": [], "batches": [], "evals": []}
    orig = (trainer_lib.make_train_step, pipe_lib.IndexSampler.batches_from_step,
            trainer_lib.Trainer.evaluate)

    def make_train_step(*a, **k):
        inner = orig[0](*a, **k)

        def step(state, batch):
            if "state" not in rec and state.get("adapters") is not None:
                rec["initial"] = {k: v.detach().float().cpu().clone()
                                  for k, v in leaves(state["adapters"])}
            rec["state"] = state
            torch.cuda.synchronize() if torch.cuda.is_available() else None
            t0 = time.perf_counter()
            m = inner(state, batch)
            rec["steps"].append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                                 "tokens": int(m["tokens"]), "s": time.perf_counter() - t0})
            return m
        return step

    def batches_from_step(self, start_step):
        it = orig[1](self, start_step) if sampler is None else iter(sampler[start_step:])
        for b in it:
            rec["batches"].append([int(i) for i in b])
            yield b

    def evaluate(self, step):
        out = orig[2](self, step)
        rec["evals"].append((step, out))
        return out

    (trainer_lib.make_train_step, pipe_lib.IndexSampler.batches_from_step,
     trainer_lib.Trainer.evaluate) = (make_train_step, batches_from_step, evaluate)
    try:
        result = train_cli.main(argv)
    finally:
        (trainer_lib.make_train_step, pipe_lib.IndexSampler.batches_from_step,
         trainer_lib.Trainer.evaluate) = orig
    return result, rec


def _tree_digest(state) -> str:
    import hashlib
    from asr_finetune_tpu_torch.training.optim import leaves
    h = hashlib.sha256()
    for t in ("adapters", "rank_mask"):
        for _, v in leaves(state[t]):
            h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_rank(spec_path: str) -> int:
    """Phase 8a's rank process (`chip_smoke.py --dp-rank <spec>`, started by
    dp_main_path with torchrun's variables): cli.train over its rows, then
    dp_rank<r>.json with its steps, index batches, evals, launches and the
    digest of its adapters and rank masks."""
    with open(spec_path) as f:
        spec = json.load(f)
    reset_all_launches()
    result, rec = _recorded_run(spec["argv"])
    out = {"result": result, "steps": rec["steps"], "batches": rec["batches"][:DP_STEPS],
           "evals": rec["evals"], "launches": all_launches(),
           "digest": _tree_digest(rec["state"])}
    with open(os.path.join(spec["dir"], f"dp_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def dp_main_path(rows, device: str = "cuda", model: str = "large-v3"):
    """Phase 8a: two ranks of cli.train on the one card (so the group is
    gloo, through the host), large-v3 PEFT over the int8 base with
    --int8_matmul and AdaLoRA (lora dropout 0.05), 2 rows a rank, 4 steps,
    an eval with the greedy WER at steps 2 and 4, a checkpoint at step 4.
    Then one process at batch 4 over the same four global batches (rank 0's
    rows, then rank 1's): per step the loss and grad_norm, and the adapters
    after four steps, within DP_LIMITS. Asserts the eval metrics are the
    same on both ranks, so are the adapters and rank masks (bit for bit),
    and each rank launched W8A8, the attention forward and backward and the
    int8 decoder kernels; then one process resumes the two ranks'
    checkpoint for 2 more steps. `device` and `model` let it run a small
    model on the CPU."""
    import torch
    from asr_finetune_tpu_torch.training.optim import leaves

    on_card = device == "cuda"
    label = "DP main path (8a)"
    tag = next(line.split("=", 1)[1].strip() for line in open(PEFT_CONFIG)
               if line.startswith("output_tag"))
    with tempfile.TemporaryDirectory() as tmp:
        data, two, one = f"{tmp}/data", f"{tmp}/two", f"{tmp}/one"
        os.makedirs(data)
        write_audiofolder(data, TRAIN_UTTS)
        ranks, wall, group = _rank_processes(
            tmp, "dp", _dp_argv(data, two, DP_BATCH, device, model), DP_RANKS, DP_TIMEOUT,
            label)
        group_line = group[0] if group else ""

        # one process over the same global batches: rank 0's rows, then rank 1's
        global_batches = [np.concatenate([np.asarray(rk["batches"][i]) for rk in ranks])
                          for i in range(DP_STEPS)]
        _, ref = _recorded_run(_dp_argv(data, one, DP_BATCH * DP_RANKS, device, model),
                               sampler=global_batches)
        ref_state = {t: {k: v.detach().float().cpu() for k, v in leaves(ref["state"][t])}
                     for t in ("adapters", "rank_mask")}
        initial = ref["initial"]
        del ref["state"]
        saved = torch.load(f"{two}/{tag}/checkpoints/step_{DP_STEPS:08d}/state.pt",
                           map_location="cpu", weights_only=True)

        # the two ranks' checkpoint, resumed in one process for 2 more steps
        resumed, res = _recorded_run(_dp_argv(data, two, DP_BATCH * DP_RANKS, device, model,
                                              "--resume_training", "--max_steps",
                                              str(DP_STEPS + 2)))
        del res["state"]

    loss_err = max(_rel(a["loss"], b["loss"]) for a, b in zip(ranks[0]["steps"], ref["steps"]))
    norm_err = max(_rel(a["grad_norm"], b["grad_norm"])
                   for a, b in zip(ranks[0]["steps"], ref["steps"]))
    gap = torch.cat([(saved["adapters"][k].float() - v).flatten()
                     for k, v in ref_state["adapters"].items()])
    update = torch.cat([(v - initial[k]).flatten() for k, v in ref_state["adapters"].items()])
    ad_err = float(gap.norm() / update.norm().clamp(min=1e-30))
    ad_max = float(gap.abs().max() / update.abs().max().clamp(min=1e-30))
    mask_flips = sum(int((saved["rank_mask"][k].float() != v).sum())
                     for k, v in ref_state["rank_mask"].items())
    reading = {"phase": "8a", "ranks": DP_RANKS, "rows_per_rank": DP_BATCH, "wall_s": wall,
               "group": group_line[-160:],
               "steps": [[{k: s[k] for k in ("loss", "grad_norm", "tokens")} for s in rk["steps"]]
                         for rk in ranks],
               "one_process": [{k: s[k] for k in ("loss", "grad_norm", "tokens")}
                               for s in ref["steps"]],
               "ms_per_step": [1e3 * float(np.mean([s["s"] for s in rk["steps"][1:]]))
                               for rk in ranks],
               "one_process_ms_per_step": 1e3 * float(np.mean([s["s"] for s in ref["steps"][1:]])),
               "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
               "adapters_rms_gap_over_update": ad_err,
               "adapters_max_gap_over_max_update": ad_max, "rank_mask_flips": mask_flips,
               "evals": [rk["evals"] for rk in ranks], "one_process_evals": ref["evals"],
               "resumed": {"result": resumed, "steps": [s["loss"] for s in res["steps"]]},
               "launches": [{k: v for k, v in rk["launches"].items() if v} for rk in ranks]}
    print(json.dumps(reading))
    if any(len(rk["steps"]) != DP_STEPS or len(rk["batches"]) != DP_STEPS for rk in ranks) \
            or len(ref["steps"]) != DP_STEPS:
        raise AssertionError(f"{label}: steps or batches missing")
    if any(not np.isfinite(s["loss"]) for rk in ranks for s in rk["steps"]):
        raise AssertionError(f"{label}: a loss is not finite")
    if reading["steps"][0] != reading["steps"][1]:
        raise AssertionError(f"{label}: the ranks' step metrics differ")
    if [s["tokens"] for s in ranks[0]["steps"]] != [s["tokens"] for s in ref["steps"]]:
        raise AssertionError(f"{label}: the global token counts differ from one process's")
    if sorted(set(ranks[0]["batches"][0]) | set(ranks[1]["batches"][0])) != sorted(
            ranks[0]["batches"][0] + ranks[1]["batches"][0]):
        raise AssertionError(f"{label}: the ranks' rows overlap: {ranks[0]['batches'][0]}, "
                             f"{ranks[1]['batches'][0]}")
    if loss_err > DP_LIMITS["loss"] or norm_err > DP_LIMITS["grad_norm"] \
            or ad_err > DP_LIMITS["adapters"]:
        raise AssertionError(f"{label}: 2 ranks against one process: loss {loss_err:.3g}, "
                             f"grad_norm {norm_err:.3g}, adapters {ad_err:.3g} > {DP_LIMITS}")
    evals = [rk["evals"] for rk in ranks]
    if evals[0] != evals[1] or [s for s, _ in evals[0]] != [2, DP_STEPS] \
            or ranks[0]["result"] != ranks[1]["result"]:
        raise AssertionError(f"{label}: the ranks' evals differ: {evals}")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError(f"{label}: the ranks hold different adapters or rank masks")
    if resumed["final_step"] != DP_STEPS + 2 or len(res["steps"]) != 2 or not all(
            np.isfinite(s["loss"]) for s in res["steps"]):
        raise AssertionError(f"{label}: one-process resume: {resumed}, {res['steps']}")
    if on_card:
        for r, rk in enumerate(ranks):
            silent = [k for k in HPO_KERNELS if rk["launches"][k] == 0]
            if silent:
                raise AssertionError(f"{label}: rank {r} launched no {silent}")
            record_launches(rows, f"dp_rank{r}", rk["launches"])
    print(f"{label}: {DP_RANKS} ranks x {DP_BATCH} rows, {DP_STEPS} steps, wall {wall:.3f} s; "
          f"against one process at batch {DP_BATCH * DP_RANKS}: loss {loss_err:.3g}, grad_norm "
          f"{norm_err:.3g}, adapters {ad_err:.3g} (max {ad_max:.3g}; limits {DP_LIMITS}), "
          f"{mask_flips} rank-mask "
          f"flips; evals equal on both ranks; resumed in one process to step "
          f"{resumed['final_step']}")


# 8d, --tp 2: two rank processes sharing the card (gloo), each run against one
# process at tp 1 over the same batches: the largest reading over the steps of
# |a - b| / |b| for the loss and grad_norm, and after 4 steps RMS(a - b) /
# RMS(b - initial) over every trained element (full fine-tuning: the
# parameters; PEFT: the adapters), as DP_LIMITS reads them. The ranks' sums
# run in another order than one process's (a rank's o and fc2 products are
# partial sums, rounded to bf16 before the two are added), and in PEFT a
# flipped int8 rounding of an activation moves a product by 1/127 of its
# row's amax. The first reading on an H100 (PERF.md): full fine-tuning loss
# 5.9e-5, grad_norm 1.6e-3 (growing over the steps, 1.1e-4 at step 1, as
# the weights drift apart), parameters 2.35e-2; PEFT loss 1.6e-4, grad_norm
# 1.3e-4, adapters 5.35e-2. Limits ~10x the larger reading of the first two
# and ~4x of the third, as DP_LIMITS.
TP_LIMITS = {"loss": 1.5e-3, "grad_norm": 1.6e-2, "weights": 0.2}
TP_STEPS, TP_TIMEOUT = 4, 900                   # steps; s, each rank process of 8d


def _tp_argv(data, out, device, model, peft, *extra):
    """8d's run of cli.train: largev3_debug.config (full fine-tuning) or
    largev3_peft_debug.config with --int8_matmul (PEFT, AdaLoRA, calibrated
    outliers) on the 20 wavs of phase 6, batch 4, 4 steps, an eval with the
    greedy WER and a checkpoint at step 4."""
    cfg = ["-c", PEFT_CONFIG, "--int8_matmul"] if peft else ["-c", TRAIN_CONFIG]
    return [*cfg, "--model_type", model, "--device", device, "--no-debug",
            "--data_mode", "folder", "--dataset_name", data, "--val_split", "0.2",
            "--per_device_train_batch_size", str(B), "--per_device_eval_batch_size", str(B),
            "--max_steps", str(TP_STEPS), "--eval_steps", str(TP_STEPS),
            "--save_steps", str(TP_STEPS), "--logging_steps", "2",
            "--eval_sample_fraction", "1.0", "--generation_max_length", str(TRAIN_GEN_LEN),
            "--wer_weight", "0.7", "--output_dir", out, *extra]


def tp_rank(spec_path: str) -> int:
    """Phase 8d's rank process (`chip_smoke.py --tp-rank <spec>`, started by
    tp_main_path with torchrun's variables): cli.train --tp 2, with its
    steps, index batches, evals, launches, the W8A8 products' shapes (and
    whether each was given the whole rows' amax), the time spent in the
    collectives a step (each timed from a synchronised device, so the wait
    for earlier kernels is not in it), peak device memory, the calibrated
    sets and the digest of its adapters and rank masks; then
    tp_rank<r>.json."""
    import torch
    from asr_finetune_tpu_torch import run as run_lib
    from asr_finetune_tpu_torch.ops import quant as Q
    from asr_finetune_tpu_torch.parallel import mesh
    from asr_finetune_tpu_torch.training import trainer as trainer_lib

    with open(spec_path) as f:
        spec = json.load(f)
    on_card = torch.cuda.is_available() and "cuda" in spec["argv"]
    st = {"comm_s": 0.0, "step_comm_s": [], "shapes": set(), "calibrated": None}
    orig = (mesh._all_reduce_, mesh.all_gather, Q.w8a8, run_lib.calibrate_outliers,
            trainer_lib.make_train_step)

    def timed(fn):
        def call(*a, **k):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            st["comm_s"] += time.perf_counter() - t0
            return out
        return call

    def w8a8(x, w_q8, *a, **k):
        st["shapes"].add((x.shape[0], x.shape[1], w_q8.shape[1], "row_amax" in k))
        return orig[2](x, w_q8, *a, **k)

    def calibrate_outliers(*a, **k):
        st["calibrated"] = orig[3](*a, **k)
        return st["calibrated"]

    def make_train_step(*a, **k):
        inner = orig[4](*a, **k)

        def step(state, batch):
            c0 = st["comm_s"]
            m = inner(state, batch)
            st["step_comm_s"].append(st["comm_s"] - c0)
            return m
        return step

    mesh._all_reduce_, mesh.all_gather = timed(orig[0]), timed(orig[1])
    Q.w8a8, run_lib.calibrate_outliers, trainer_lib.make_train_step = (
        w8a8, calibrate_outliers, make_train_step)
    reset_all_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        result, rec = _recorded_run(spec["argv"])
    finally:
        (mesh._all_reduce_, mesh.all_gather, Q.w8a8, run_lib.calibrate_outliers,
         trainer_lib.make_train_step) = orig
    peft = rec["state"].get("adapters") is not None
    out = {"result": result, "steps": rec["steps"], "batches": rec["batches"][:TP_STEPS],
           "evals": rec["evals"], "launches": all_launches(),
           "step_comm_s": st["step_comm_s"][:TP_STEPS],
           "w8a8_shapes": sorted(st["shapes"]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0,
           "calibrated": None if st["calibrated"] is None else sorted(
               [list(k), list(v)] for k, v in st["calibrated"].items()),
           "digest": _tree_digest(rec["state"]) if peft else None}
    with open(os.path.join(spec["dir"], f"tp_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _rank_processes(tmp, kind: str, argv, n: int, timeout: float, label: str, **extra):
    """n rank processes of `chip_smoke.py --<kind>-rank` (dp_rank, tp_rank
    or hpo_rank) over the entry point's `argv` (and `extra` in their spec),
    with torchrun's variables; returns their records (<kind>_rank<r>.json),
    the wall time and rank 0's lines about its group."""
    spec = f"{tmp}/{kind}_spec.json"
    with open(spec, "w") as f:
        json.dump({"dir": tmp, "argv": argv, **extra}, f)
    port = _free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(n):
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(n),
                   "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(n),
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
            logs.append(open(f"{tmp}/{kind}_rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), f"--{kind}-rank", spec],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(f"{tmp}/{kind}_rank{r}.log") as f:
                tail = f.read()[-8000:]
            raise AssertionError(f"{label}: rank {r} exited {p.returncode}:\n{tail}")
    ranks = []
    for r in range(n):
        with open(f"{tmp}/{kind}_rank{r}.json") as f:
            ranks.append(json.load(f))
    with open(f"{tmp}/{kind}_rank0.log") as f:
        group = [line.strip() for line in f if "process group" in line
                 or "tensor parallel" in line or "trial packing" in line]
    return ranks, wall, group


def tp_main_path(rows, peft: bool, device: str = "cuda", model: str = "large-v3"):
    """Phase 8d, tensor parallelism: two rank processes of `cli.train --tp 2`
    share the card (a gloo group), whisper-large-v3 at full width and depth,
    (i) full fine-tuning (largev3_debug.config) or (ii) PEFT over the int8
    base with --int8_matmul, AdaLoRA and calibrated outliers: batch 4 (both
    ranks read the same rows, each runs 10 heads and half the MLP), 4 steps,
    an eval with the greedy WER (the plain decode step over each rank's
    heads) and a checkpoint at step 4. Then one process at tp 1 over the
    same batches: per step the loss and grad_norm, and the trained weights
    after 4 steps (the ranks' checkpoint, gathered whole) against it within
    TP_LIMITS; (ii) the calibrated sets equal to one process's and the
    rank masks equal on both ranks. Each rank must have launched the
    encoder-attention forward and backward and, in (ii), W8A8 at the split
    shapes (the row-split ones with the whole rows' amax). Then one process
    resumes the ranks' checkpoint for 2 steps. Prints ms/step, peak memory
    a rank and the collectives' share of a step; gloo stages every
    collective through the host, so no time here is a target."""
    import torch
    from asr_finetune_tpu_torch import run as run_lib
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.models.configs import get_config
    from asr_finetune_tpu_torch.training import checkpoint as ckpt_lib
    from asr_finetune_tpu_torch.training.optim import leaves

    on_card = device == "cuda"
    kind = "PEFT" if peft else "full FT"
    label = f"TP main path (8d, {kind})"
    config = PEFT_CONFIG if peft else TRAIN_CONFIG
    tag = next(line.split("=", 1)[1].strip() for line in open(config)
               if line.startswith("output_tag"))
    tree = "adapters" if peft else "params"
    with tempfile.TemporaryDirectory() as tmp:
        data, two, one = f"{tmp}/data", f"{tmp}/two", f"{tmp}/one"
        os.makedirs(data)
        write_audiofolder(data, TRAIN_UTTS)
        ranks, wall, group = _rank_processes(
            tmp, "tp", _tp_argv(data, two, device, model, peft, "--tp", str(TP)), TP,
            TP_TIMEOUT, label)
        batches = [np.asarray(b) for b in ranks[0]["batches"]]
        # one process over the same batches; its checkpoint is not written
        calib = {}
        orig = (ckpt_lib.CheckpointManager.save, run_lib.calibrate_outliers)

        def calibrate_outliers(*a, **k):
            calib["sets"] = orig[1](*a, **k)
            return calib["sets"]
        ckpt_lib.CheckpointManager.save = lambda *a, **k: False
        run_lib.calibrate_outliers = calibrate_outliers
        try:
            _, ref = _recorded_run(_tp_argv(data, one, device, model, peft), sampler=batches)
        finally:
            ckpt_lib.CheckpointManager.save, run_lib.calibrate_outliers = orig
        state = ref.pop("state")
        final = dict(leaves(state[tree]))
        ref_masks = dict(leaves(state["rank_mask"])) if peft else {}
        del state
        saved = torch.load(f"{two}/{tag}/checkpoints/step_{TP_STEPS:08d}/state.pt",
                           map_location="cpu", weights_only=True, mmap=True)
        initial = ref["initial"] if peft else dict(leaves(W.init_params(
            get_config(model), seed=1337, device=device)))
        gap2 = upd2 = 0.0
        for k, v in final.items():
            v = v.detach().float()
            gap2 += float((saved[tree][k].to(v.device).float() - v).square().sum())
            upd2 += float((v - initial[k].to(v.device).float()).square().sum())
        w_err = (gap2 / max(upd2, 1e-30)) ** 0.5
        mask_flips = sum(int((saved["rank_mask"][k].to(v.device) != v).sum())
                         for k, v in ref_masks.items())
        held_whole = all(tuple(saved[tree][k].shape) == tuple(v.shape)
                         for k, v in final.items())
        del final, initial, ref_masks, saved
        if on_card:
            torch.cuda.empty_cache()

        # the ranks' checkpoint resumed in one process for 2 steps (not saved again)
        ckpt_lib.CheckpointManager.save = lambda *a, **k: False
        try:
            resumed, res = _recorded_run(_tp_argv(data, two, device, model, peft,
                                                  "--resume_training", "--max_steps",
                                                  str(TP_STEPS + 2)))
        finally:
            ckpt_lib.CheckpointManager.save = orig[0]
        del res["state"]
        if on_card:
            torch.cuda.empty_cache()

    loss_err = max(_rel(a["loss"], b["loss"]) for a, b in zip(ranks[0]["steps"], ref["steps"]))
    norm_err = max(_rel(a["grad_norm"], b["grad_norm"])
                   for a, b in zip(ranks[0]["steps"], ref["steps"]))
    ms = [1e3 * float(np.mean([s_["s"] for s_ in rk["steps"][1:]])) for rk in ranks]
    comm = [float(np.sum(rk["step_comm_s"][1:]) / np.sum([s_["s"] for s_ in rk["steps"][1:]]))
            for rk in ranks]
    calibrated = None if not peft else sorted(
        [list(k), list(v)] for k, v in calib["sets"].items())
    reading = {"phase": "8d", "kind": kind, "tp": TP, "wall_s": wall, "group": group,
               "steps": [[{k: s_[k] for k in ("loss", "grad_norm", "tokens")}
                          for s_ in rk["steps"]] for rk in ranks],
               "one_process": [{k: s_[k] for k in ("loss", "grad_norm", "tokens")}
                               for s_ in ref["steps"]],
               "ms_per_step": ms,
               "one_process_ms_per_step": 1e3 * float(np.mean([s_["s"] for s_ in ref["steps"][1:]])),
               "collectives_share_of_step": comm, "peak_gib": [rk["peak_gib"] for rk in ranks],
               "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
               "weights_rms_gap_over_update": w_err, "rank_mask_flips": mask_flips,
               "calibrated_equal": None if not peft else ranks[0]["calibrated"] == calibrated,
               "evals": [rk["evals"] for rk in ranks], "one_process_evals": ref["evals"],
               "w8a8_shapes": ranks[0]["w8a8_shapes"],
               "resumed": {"result": resumed, "steps": [s_["loss"] for s_ in res["steps"]]},
               "launches": [{k: v for k, v in rk["launches"].items() if v} for rk in ranks]}
    print(json.dumps(reading))
    if any(len(rk["steps"]) != TP_STEPS for rk in ranks) or len(ref["steps"]) != TP_STEPS:
        raise AssertionError(f"{label}: steps missing")
    if any(not np.isfinite(s_["loss"]) for rk in ranks for s_ in rk["steps"]):
        raise AssertionError(f"{label}: a loss is not finite")
    if reading["steps"][0] != reading["steps"][1] or ranks[0]["result"] != ranks[1]["result"]:
        raise AssertionError(f"{label}: the ranks' step metrics or results differ")
    if [s_["tokens"] for s_ in ranks[0]["steps"]] != [s_["tokens"] for s_ in ref["steps"]]:
        raise AssertionError(f"{label}: the token counts differ from one process's")
    if ranks[0]["batches"] != ranks[1]["batches"]:
        raise AssertionError(f"{label}: the ranks of a model group read different rows")
    evals = [rk["evals"] for rk in ranks]
    if evals[0] != evals[1] or [st for st, _ in evals[0]] != [TP_STEPS] \
            or not np.isfinite(evals[0][0][1]["eval_wer"]):
        raise AssertionError(f"{label}: the ranks' evals: {evals}")
    if not held_whole:
        raise AssertionError(f"{label}: the checkpoint does not hold the whole {tree}")
    if peft and (not reading["calibrated_equal"] or ranks[0]["calibrated"] != ranks[1]["calibrated"]
                 or ranks[0]["digest"] != ranks[1]["digest"]):
        raise AssertionError(f"{label}: calibrated sets {ranks[0]['calibrated']} / "
                             f"{ranks[1]['calibrated']} (one process {calibrated}) or the "
                             "ranks' adapters and rank masks differ")
    if loss_err > TP_LIMITS["loss"] or norm_err > TP_LIMITS["grad_norm"] \
            or w_err > TP_LIMITS["weights"]:
        raise AssertionError(f"{label}: tp {TP} against one process: loss {loss_err:.3g}, "
                             f"grad_norm {norm_err:.3g}, weights {w_err:.3g} > {TP_LIMITS}")
    if resumed["final_step"] != TP_STEPS + 2 or len(res["steps"]) != 2 or not all(
            np.isfinite(s_["loss"]) for s_ in res["steps"]):
        raise AssertionError(f"{label}: one-process resume: {resumed}, {res['steps']}")
    if on_card:
        want = ("encoder_attention", "encoder_attention_bwd") + (("w8a8",) if peft else ())
        split = {(K, N) for _, _, K, N in TP_W8A8_SHAPES}
        for r, rk in enumerate(ranks):
            silent = [k for k in want if rk["launches"][k] == 0]
            if silent:
                raise AssertionError(f"{label}: rank {r} launched no {silent}")
            record_launches(rows, f"tp_{'peft' if peft else 'full'}_rank{r}", rk["launches"])
            if peft:
                seen = {(K, N) for _, K, N, _ in rk["w8a8_shapes"]}
                row_split = {(K, N) for _, K, N, amax in rk["w8a8_shapes"] if amax}
                if not seen <= split or row_split != {(D // TP, D), (FF // TP, D)}:
                    raise AssertionError(f"{label}: rank {r} W8A8 shapes {sorted(seen)} "
                                         f"(given the row amax: {sorted(row_split)})")
    print(f"{label}: {TP} ranks x {B} rows, {TP_STEPS} steps, wall {wall:.3f} s; ms/step "
          f"{ms[0]:.3f} / {ms[1]:.3f} (one process {reading['one_process_ms_per_step']:.3f}); "
          f"collectives {100 * comm[0]:.1f}% / {100 * comm[1]:.1f}% of a step; peak "
          f"{reading['peak_gib'][0]:.2f} / {reading['peak_gib'][1]:.2f} GiB a rank; against "
          f"one process: loss {loss_err:.3g}, grad_norm {norm_err:.3g}, {tree} {w_err:.3g} "
          f"(limits {TP_LIMITS}), {mask_flips} rank-mask flips; evals equal on both ranks; "
          f"resumed in one process to step {resumed['final_step']}")


# Phase 7d, trial packing (hpo/controller.py over parallel/mesh.trial_groups):
# 7c's flags, random search, 2 steps a trial with an eval at step 2. (i) two
# rank processes share the card (gloo), --chips_per_trial 1
# --max_concurrent_trials 2: two slots of one rank, 4 trials, against one
# process running the same 4 trials one after another; (ii) four rank
# processes, --chips_per_trial 2: two slots of two data ranks (2 rows a rank),
# 2 trials, against one process at the global batch of 4. Losses within
# DP_LIMITS["loss"], as 8a reads its two ranks against one process.
PACK_STEPS, PACK_TRIALS, PACK_TIMEOUT = 2, 4, 600   # steps, trials of (i); s a rank


def _recorded_hpo(argv, resume: bool = False) -> dict:
    """cli.train_hyper.main(argv) with each trial recorded: its slot, rank
    and group size, wall interval (the host's clock, comparable across
    processes), step losses, launches, peak device memory and the memory
    allocated after it; with `resume`, then once more with
    --resume_training, recording what that ran and launched."""
    import torch
    from asr_finetune_tpu_torch import run as run_lib
    from asr_finetune_tpu_torch.cli import train_hyper
    from asr_finetune_tpu_torch.parallel import mesh
    from asr_finetune_tpu_torch.training import trainer as trainer_lib

    on_card = torch.cuda.is_available() and "cpu" not in argv
    trials, losses = [], []
    orig = (run_lib.run_trial, trainer_lib.make_train_step)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def make_train_step(*a, **k):
        inner = orig[1](*a, **k)

        def step(state, batch):
            m = inner(state, batch)
            losses.append(float(m["loss"]))
            return m
        return step

    def run_trial(args, hp=None, trial_dir=None, **k):
        sync()
        before, n = all_launches(), len(losses)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        rec = {"trial": os.path.basename(trial_dir), "hp": hp, "slot": mesh.trial_slot(),
               "rank": mesh.rank(), "world": mesh.world(), "start": time.time()}
        try:
            return orig[0](args, hp, trial_dir, **k)
        finally:
            sync()
            after = all_launches()
            rec.update(end=time.time(), losses=losses[n:],
                       launches={c: after[c] - before[c] for c in after},
                       peak=torch.cuda.max_memory_allocated() if on_card else 0,
                       allocated=torch.cuda.memory_allocated() if on_card else 0)
            trials.append(rec)

    run_lib.run_trial, trainer_lib.make_train_step = run_trial, make_train_step
    try:
        sync()
        out = {"base": torch.cuda.memory_allocated() if on_card else 0}
        t0 = time.perf_counter()
        out["summary"] = train_hyper.main(argv)
        out["wall"] = time.perf_counter() - t0
        out["trials"] = list(trials)
        if resume:
            reset_all_launches()
            out["resumed"] = train_hyper.main(argv + ["--resume_training"])
            out["resume_trials"] = trials[len(out["trials"]):]
            out["resume_launches"] = {k: v for k, v in all_launches().items() if v}
    finally:
        run_lib.run_trial, trainer_lib.make_train_step = orig
    return out


def hpo_rank(spec_path: str) -> int:
    """Phase 7d's rank process (`chip_smoke.py --hpo-rank <spec>`, started by
    hpo_packed_path with torchrun's variables): `_recorded_hpo` over the
    spec's argv in one group for the run and its resume, then
    hpo_rank<r>.json."""
    from asr_finetune_tpu_torch.parallel import mesh
    with open(spec_path) as f:
        spec = json.load(f)
    reset_all_launches()
    with mesh.joined("cpu" if "cpu" in spec["argv"] else "cuda"):
        out = _recorded_hpo(spec["argv"], resume=spec.get("resume", False))
    with open(os.path.join(spec["dir"], f"hpo_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f, default=str)
    return 0


def hpo_packed_path(rows, device: str = "cuda", model: str = "large-v3"):
    """Phase 7d, trial packing (comment above PACK_STEPS). (i) asserts every
    trial completed once, two at once (their wall intervals overlap), each
    trial's hp equal to the serial run's and its step losses within
    DP_LIMITS["loss"], each trial on each rank launched W8A8, the
    encoder-attention forward and backward and the int8 decoder kernels,
    the device memory came back within HPO_MEM_MARGIN after each, the ranks
    return one summary, and --resume_training runs nothing, launches
    nothing and names the same best trial. (ii) asserts each trial ran on
    the two ranks of one slot, the slots at once, its hp and step losses as
    one process's at the global batch, and the kernels launched. Prints
    one JSON line per sub-phase: wall of the packed run against the one
    process, peak memory a rank, launches. `device` and `model` let it run
    a small model on the CPU."""
    import torch

    on_card = device == "cuda"
    label = "HPO packed (7d)"
    tag = next(line.split("=", 1)[1].strip() for line in open(PEFT_CONFIG)
               if line.startswith("output_tag"))
    if on_card:
        torch.cuda.empty_cache()     # the rank processes share the card

    def argv(store, trials, batch, *extra):
        return ["-c", PEFT_CONFIG, "--model_type", model, "--device", device, "--no-debug",
                "--int8_matmul", "--data_mode", "folder", "--dataset_name", data,
                "--val_split", "0.2", "--search_schedule_mode", "small_small",
                "--num_samples", str(trials), "--max_steps", str(PACK_STEPS),
                "--eval_steps", str(PACK_STEPS), "--save_steps", str(PACK_STEPS),
                "--grace_period", str(PACK_STEPS), "--logging_steps", str(PACK_STEPS),
                "--per_device_train_batch_size", str(batch),
                "--eval_sample_fraction", "1.0", "--generation_max_length",
                str(TRAIN_GEN_LEN), "--wer_weight", "0.7", "--storage_path", store, *extra]

    def by_trial(recs):
        out = {}
        for r in recs:
            out.setdefault(r["trial"], []).append(r)
        return out

    def loss_err(packed, ref):
        return max(_rel(a, b) for a, b in zip(packed["losses"], ref["losses"]))

    def launched(recs, what):
        for r in recs:
            silent = [k for k in HPO_KERNELS if r["launches"][k] == 0]
            if on_card and silent:
                raise AssertionError(f"{label} {what}: {r['trial']} on rank {r['rank']} of "
                                     f"slot {r['slot']} launched no {silent}")

    def overlapping(recs):
        return any(a["start"] < b["end"] and b["start"] < a["end"]
                   for a in recs for b in recs if a["slot"] != b["slot"])

    with tempfile.TemporaryDirectory() as tmp:
        data = f"{tmp}/data"
        os.makedirs(data)
        write_audiofolder(data, TRAIN_UTTS)
        readings = []
        for sub, n_ranks, chips, trials, batch in (("i", 2, 1, PACK_TRIALS, B),
                                                   ("ii", 4, 2, 2, B // 2)):
            what = f"({sub}) {n_ranks} ranks, --chips_per_trial {chips}"
            d = f"{tmp}/{sub}"
            os.makedirs(d)
            t0 = time.perf_counter()
            ranks, _, group = _rank_processes(
                d, "hpo", argv(f"{d}/packed", trials, batch, "--chips_per_trial", str(chips),
                               "--max_concurrent_trials", "2"),
                n_ranks, PACK_TIMEOUT, label, resume=sub == "i")
            wall = time.perf_counter() - t0
            # one process: the same trials one after another (i), at the
            # global batch (ii)
            ref = _recorded_hpo(argv(f"{d}/one", trials, batch * chips))
            with open(f"{d}/packed/{tag}/experiment_state.json") as f:
                state = json.load(f)["trials"]
            recs = [t for rk in ranks for t in rk["trials"]]
            ran, want = by_trial(recs), {t["trial"]: t for t in ref["trials"]}
            ids = [f"trial_{i:04d}" for i in range(trials)]
            errs = {t: loss_err(ran[t][0], want[t]) for t in ids if t in ran and t in want}
            reading = {
                "phase": "7d", "sub": sub, "ranks": n_ranks, "chips_per_trial": chips,
                "rows_per_rank": batch, "trials": trials, "group": group[-1][-160:] if group
                else "", "packed_wall_s": wall,
                "packed_experiment_wall_s": [rk["wall"] for rk in ranks],
                "one_process_wall_s": ref["wall"],
                "peak_gib_by_rank": [max((t["peak"] for t in rk["trials"]), default=0) / 2**30
                                     for rk in ranks],
                "allocated_after_mib": [[(t["allocated"] - rk["base"]) / 2**20
                                         for t in rk["trials"]] for rk in ranks],
                "by_trial": {t: {"slot": ran[t][0]["slot"], "ranks": len(ran[t]),
                                 "wall_s": ran[t][0]["end"] - ran[t][0]["start"],
                                 "losses": ran[t][0]["losses"],
                                 "one_process_losses": want[t]["losses"],
                                 "loss_rel_err": errs.get(t)} for t in ids if t in ran},
                "launches_by_rank": [
                    {k: v for k, v in _sum_launches(rk["trials"]).items() if v}
                    for rk in ranks]}
            if sub == "i":
                reading["resume"] = [{"trials_run": len(rk["resume_trials"]),
                                      "launches": rk["resume_launches"],
                                      "best": rk["resumed"]["best_trial"]} for rk in ranks]
            readings.append(reading)
            print(json.dumps(reading))

            if sorted(state) != ids or any(state[t]["status"] != "completed" for t in ids):
                raise AssertionError(f"{label} {what}: trials "
                                     f"{ {k: v['status'] for k, v in state.items()} }")
            if sorted(ran) != ids or any(len(ran[t]) != chips for t in ids) or any(
                    len({r["slot"] for r in ran[t]}) != 1
                    or sorted(r["rank"] for r in ran[t]) != list(range(chips))
                    or any(r["world"] != chips for r in ran[t]) for t in ids):
                raise AssertionError(f"{label} {what}: trials ran "
                                     f"{ {t: [(r['slot'], r['rank']) for r in v] for t, v in ran.items()} }")
            if {r["slot"] for r in recs} != {0, 1} or not overlapping(recs):
                raise AssertionError(f"{label} {what}: no two trials ran at once")
            for t in ids:
                if ran[t][0]["hp"] != want[t]["hp"] or len(ran[t][0]["losses"]) != PACK_STEPS:
                    raise AssertionError(f"{label} {what}: {t} hp {ran[t][0]['hp']} (one "
                                         f"process {want[t]['hp']}), losses "
                                         f"{ran[t][0]['losses']}")
                if any(r["losses"] != ran[t][0]["losses"] for r in ran[t]):
                    raise AssertionError(f"{label} {what}: {t}'s ranks differ")
                if errs[t] > DP_LIMITS["loss"] or not all(np.isfinite(ran[t][0]["losses"])):
                    raise AssertionError(f"{label} {what}: {t} losses {ran[t][0]['losses']} "
                                         f"against one process's {want[t]['losses']}")
            launched(recs, what)
            for rk in ranks:
                for t in rk["trials"]:
                    if t["allocated"] - rk["base"] > HPO_MEM_MARGIN:
                        raise AssertionError(
                            f"{label} {what}: {t['trial']} left "
                            f"{(t['allocated'] - rk['base']) / 2**20:.1f} MiB allocated")
            summaries = [rk["summary"] for rk in ranks]
            if any(s != summaries[0] for s in summaries) or summaries[0]["best_trial"] not in ids:
                raise AssertionError(f"{label} {what}: summaries {summaries}")
            if sub == "i" and any(rk["resume_trials"] or rk["resume_launches"]
                                  or rk["resumed"]["best_trial"] != summaries[0]["best_trial"]
                                  for rk in ranks):
                raise AssertionError(f"{label} {what}: the resume ran {reading['resume']}")
            if on_card:
                record_launches(rows, f"train_hyper_packed_{sub}", {
                    k: sum(_sum_launches(rk["trials"])[k] for rk in ranks)
                    for k in all_launches()})
            print(f"{label} {what}: {trials} trials over 2 slots in {wall:.3f} s (one "
                  f"process {ref['wall']:.3f} s), largest step-loss gap "
                  f"{max(errs.values()):.3g} (limit {DP_LIMITS['loss']}), peak "
                  f"{max(reading['peak_gib_by_rank']):.2f} GiB a rank"
                  + ("; resumed: no trial run, no launch" if sub == "i" else ""))
    if on_card:
        torch.cuda.empty_cache()
    return readings


def _sum_launches(trials) -> dict:
    """The launch counts of a rank's trials, summed."""
    total = {k: 0 for k in all_launches()}
    for t in trials:
        for k, v in t["launches"].items():
            total[k] += v
    return total



def offload_path(rows, peft: bool, device: str = "cuda", model: str = "large-v3"):
    """Phase 8b (full fine-tuning, --offload_optimizer, 3 steps) or 8c (PEFT
    over the int8 base with --int8_matmul, --offload_param
    --offload_optimizer, 3 steps and an eval): cli.train in one rank of a
    process group (WORLD_SIZE=1: NCCL on the card) on phase 6's 20 wavs.

    Offload moves where the state lives, never the arithmetic. But the bf16
    attention backward adds dq by TMA reduce-add, in an order that varies
    run to run (csrc/encoder_attention.cu), and CUDA's index backward of the token embedding is
    not deterministic either; so the bit-for-bit check takes a resident and
    an offloaded run that both use plain attention (ASR_TPU_ATTN_IMPL=xla)
    and torch's deterministic algorithms, and asserts their losses and grad
    norms (8c: also the eval metrics and the adapters) equal. A third run,
    offloaded on the kernels, is the path itself: its launches, peak memory
    and ms/step, printed against phase 6's (8c: phase 7's). In every
    offloaded run AdamW's m and v (8c: every leaf of the base too) are
    pinned host tensors before each step, and (8c) the device memory
    allocated after each step but the first is within OFFLOAD_MEM_MARGIN of
    its value before it."""
    import torch
    from asr_finetune_tpu_torch.training import checkpoint as ckpt_lib
    from asr_finetune_tpu_torch.training import trainer as trainer_lib
    from asr_finetune_tpu_torch.training.optim import leaves

    on_card = device == "cuda"
    phase = "8c" if peft else "8b"
    label = f"offload main path ({phase})"
    flags = ("--offload_param", "--offload_optimizer") if peft else ("--offload_optimizer",)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = f"{tmp}/data"
        os.makedirs(data)
        write_audiofolder(data, TRAIN_UTTS)
        for name, more, exact in (("resident", (), True), ("offload", flags, True),
                                  ("offload, kernels", flags, False)):
            argv = ["-c", PEFT_CONFIG if peft else TRAIN_CONFIG, "--model_type", model,
                    "--device", device, "--no-debug", "--data_mode", "folder",
                    "--dataset_name", data, "--val_split", "0.2",
                    "--max_steps", str(OFFLOAD_STEPS), "--eval_steps", str(OFFLOAD_STEPS),
                    "--save_steps", str(OFFLOAD_STEPS), "--logging_steps", str(OFFLOAD_STEPS),
                    "--eval_sample_fraction", "1.0", "--generation_max_length",
                    str(TRAIN_GEN_LEN), "--wer_weight", "0.7",
                    "--output_dir", f"{tmp}/{len(runs)}",
                    *(("--int8_matmul",) if peft else ("--eval_delay", str(OFFLOAD_STEPS + 1))),
                    *more]
            st = {"placement": [], "memory": []}
            orig = (trainer_lib.make_train_step, ckpt_lib.CheckpointManager.save)

            def make_train_step(*a, _st=st, _more=more, **k):
                inner = orig[0](*a, **k)

                def step(state, batch):
                    if _more:
                        opt = state["opt_state"]
                        held = opt["mu"] + opt["nu"] + (
                            [t for _, t in leaves(state["params"])] if peft else [])
                        _st["placement"].append(all(t.device.type == "cpu" and t.is_pinned()
                                                    for t in held) if on_card else True)
                    before = torch.cuda.memory_allocated() if on_card else 0
                    m = inner(state, batch)
                    if on_card:
                        torch.cuda.synchronize()
                    _st["memory"].append((torch.cuda.memory_allocated() if on_card else 0)
                                         - before)
                    _st["state"] = state
                    return m
                return step

            def save(self, step, state, metrics=None):
                # 8b: phase 6 writes the full checkpoint; this one would be 18.5 GB
                return False if not peft else orig[1](self, step, state, metrics)

            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                              MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
            if exact:
                os.environ["ASR_TPU_ATTN_IMPL"] = "xla"
                torch.use_deterministic_algorithms(True, warn_only=True)
            trainer_lib.make_train_step, ckpt_lib.CheckpointManager.save = make_train_step, save
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            reset_all_launches()
            try:
                result, rec = _recorded_run(argv)
            finally:
                trainer_lib.make_train_step, ckpt_lib.CheckpointManager.save = orig
                torch.use_deterministic_algorithms(False)
                for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                          "MASTER_ADDR", "MASTER_PORT", "ASR_TPU_ATTN_IMPL"):
                    os.environ.pop(k, None)
            trees = ("adapters", "rank_mask") if peft else ()
            runs[name] = {
                "result": result, "steps": rec["steps"], "evals": rec["evals"],
                "placement": st["placement"], "memory": st["memory"],
                "launches": all_launches(),
                "peak": torch.cuda.max_memory_allocated() if on_card else 0,
                "trees": {t: {k: v.detach().cpu() for k, v in leaves(st["state"][t])}
                          for t in trees}}
            del st["state"], rec["state"]
            if on_card:
                torch.cuda.empty_cache()

    res, off, kern = runs["resident"], runs["offload"], runs["offload, kernels"]
    earlier = TRAIN_READINGS.get("PEFT main path" if peft else "train main path", {})
    ms = {n: 1e3 * float(np.mean([s["s"] for s in r["steps"][1:]])) for n, r in runs.items()}
    reading = {"phase": phase, "flags": list(flags), "steps": OFFLOAD_STEPS,
               "losses": {n: [s["loss"] for s in r["steps"]] for n, r in runs.items()},
               "grad_norms": {n: [s["grad_norm"] for s in r["steps"]] for n, r in runs.items()},
               "evals": {n: r["evals"] for n, r in runs.items()},
               "ms_per_step": ms, "peak_gib": {n: r["peak"] / 2**30 for n, r in runs.items()},
               f"phase_{'7' if peft else '6'}": earlier,
               "pinned_before_steps": {n: r["placement"] for n, r in runs.items()},
               "allocated_after_minus_before_mib": {n: [m / 2**20 for m in r["memory"]]
                                                    for n, r in runs.items()},
               "launches": {k: v for k, v in kern["launches"].items() if v}}
    print(json.dumps(reading))
    if any(len(r["steps"]) != OFFLOAD_STEPS or not all(np.isfinite(s["loss"]) for s in r["steps"])
           for r in runs.values()):
        raise AssertionError(f"{label}: expected {OFFLOAD_STEPS} finite steps a run")
    if [(s["loss"], s["grad_norm"]) for s in off["steps"]] != [
            (s["loss"], s["grad_norm"]) for s in res["steps"]]:
        raise AssertionError(f"{label}: losses or grad norms differ from the resident run's")
    if off["evals"] != res["evals"] or off["result"] != res["result"] \
            or len(kern["evals"]) != int(peft):
        raise AssertionError(f"{label}: eval metrics differ from the resident run's")
    for t, tree in res["trees"].items():
        if any(not torch.equal(v, off["trees"][t][k]) for k, v in tree.items()):
            raise AssertionError(f"{label}: {t} differ from the resident run's")
    if not all(off["placement"] + kern["placement"]) \
            or len(kern["placement"]) != OFFLOAD_STEPS:
        raise AssertionError(f"{label}: state not in pinned host memory before each step")
    if peft and any(m > OFFLOAD_MEM_MARGIN for r in (off, kern) for m in r["memory"][1:]):
        raise AssertionError(f"{label}: a step left more allocated: {off['memory']}, "
                             f"{kern['memory']} bytes")
    if on_card:
        silent = [k for k in (HPO_KERNELS if peft else ("encoder_attention",
                                                         "encoder_attention_bwd"))
                  if kern["launches"][k] == 0]
        if silent:
            raise AssertionError(f"{label}: launched no {silent}")
        record_launches(rows, "offload_peft" if peft else "offload_full", kern["launches"])
    other = "7" if peft else "6"
    print(f"{label}: {OFFLOAD_STEPS} steps{' and an eval' if peft else ''} bit-equal to "
          f"resident (plain attention, deterministic algorithms); on the kernels: peak "
          f"{kern['peak'] / 2**30:.2f} GiB (phase {other}: "
          f"{earlier.get('peak_gib', float('nan')):.2f}), {ms['offload, kernels']:.3f} "
          f"ms/step (phase {other}: {earlier.get('step_ms', float('nan')):.3f}); plain "
          f"attention: peak {off['peak'] / 2**30:.2f} GiB offloaded, {res['peak'] / 2**30:.2f} "
          f"resident, {ms['offload']:.3f} and {ms['resident']:.3f} ms/step; allocated after - "
          f"before each step {[round(m / 2**20, 3) for m in kern['memory']]} MiB")


# Phase 9, the training options: 9a whisper-small full fine-tuning
# with SpecAugment at bench.py's full_ft batch; 9b large-v3 PEFT-int8 on host
# log-mel features; 9c the remat save points
SMALL_BATCH = 8
# 9b against phase 7 on the same data: the step-1 loss, relative. Host
# float64 features differ from the device's fp32 product form by ~1e-5.
HOST_LOSS_RTOL = 1e-3
# 9c: steps a run on plain attention (bit equality) and on the kernels
# (ms/step over the steps after the first), and the kernel runs' step-2
# loss and grad norms against "mid", relative: the bf16 attention backward
# adds dq in an order that varies run to run, so on the kernels the
# modes agree only to that variation (step 1's loss is bit-equal)
REMAT_STEPS_PLAIN, REMAT_STEPS = 2, 3
REMAT_KERNEL_RTOL = 1e-3


def check_spec_augment_draws(device: str = "cuda"):
    """9a's draws on the card: one (seed, stream) masks a batch the same way
    twice and another stream otherwise; widths and starts keep the JAX law
    over 100,000 rows of each axis; and a masking call at 9a's shape (8 x
    3000 x 80) makes no synchronising call (torch.cuda's sync debug mode set
    to raise) and no device-to-host copy (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.ops import spec_augment as SA
    from asr_finetune_tpu_torch.training import train_step as TS

    dev = torch.device(device)
    mel = torch.randn((SMALL_BATCH, 3000, 80), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    a, again, other = (TS.spec_augment_stream(0, s)(mel) for s in (5, 5, 6))
    if not torch.equal(a, again) or torch.equal(a, other):
        raise AssertionError("SpecAugment: the same stream drew other masks, or another "
                             "stream the same")
    checks = []
    for length, param in ((80, 27), (3000, 100)):
        max_w = min(param, length)
        w, st = SA.draw_spans(W.site_generator(0, 1, f"law{length}", dev), 100_000,
                              length, max_w, 2)
        checks += [w.min() == 0, w.max() == max_w,
                   torch.bincount(w.flatten(), minlength=max_w + 1).gt(0).all(),
                   (st >= 0).all(), (st < (length - w).clamp(min=1)).all()]
    ok = torch.stack(checks).cpu()
    if not bool(ok.all()):
        raise AssertionError(f"SpecAugment draws break the law: {ok.tolist()}")
    fn = TS.spec_augment_stream(0, 7)
    fn(mel)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn(mel)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()})
    host = [n for n in names if "DtoH" in n or n in ("aten::item", "aten::_local_scalar_dense")]
    if host:
        raise AssertionError(f"SpecAugment masking copies to the host: {host}")
    kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    masked = float((out != mel).float().mean())
    print(f"SpecAugment on the card: a stream repeats, another differs; widths and starts "
          f"within the law over 100,000 rows (every width drawn); one masking call of "
          f"{SMALL_BATCH} x 3000 x 80: {kernels} device events, no sync, no device-to-host "
          f"copy; {100 * masked:.1f}% of the features masked")


def spec_augment_path(rows, device: str = "cuda"):
    """Phase 9a: `cli.train` with largev3_debug.config at whisper-small
    (12+12 layers, d 768), full fine-tuning with --spec_augment at batch 8
    (bench.py's full_ft cell, BASELINE.json's capability config 2), 4 steps,
    an eval and a checkpoint at step 4, after the draws' own checks on the
    card (`check_spec_augment_draws`)."""
    if device == "cuda":
        check_spec_augment_draws(device)
    train_main_path(rows, device=device, model="small",
                    extra=("--spec_augment", "--per_device_train_batch_size", str(SMALL_BATCH),
                           "--per_device_eval_batch_size", str(SMALL_BATCH)),
                    batch=SMALL_BATCH, path="spec_augment_small",
                    label="SpecAugment main path (9a, whisper-small)")


def host_logmel_path(rows, device: str = "cuda", model: str = "large-v3"):
    """Phase 9b: phase 7 (large-v3 PEFT over the int8 base, --int8_matmul)
    with --host_logmel: the collator makes the float64 log-mel in the
    prefetch thread and the steps, the calibration and the eval read "mel".
    Against phase 7 on the same data: the calibrated classes with as many
    columns each, and the step-1 loss within HOST_LOSS_RTOL."""
    label = "host log-mel PEFT main path (9b)"
    train_main_path(rows, device=device, model=model, config=PEFT_CONFIG,
                    extra=("--int8_matmul", "--host_logmel"), path="host_logmel_peft",
                    label=label)
    ours, p7 = TRAIN_READINGS[label], TRAIN_READINGS["PEFT main path"]
    rel = _rel(ours["loss1"], p7["loss1"])
    cols = {k: len(v) for k, v in ours["calib"].items()}
    cols7 = {k: len(v) for k, v in p7["calib"].items()}
    same = {k: sorted(set(v) & set(p7["calib"].get(k, ()))) == sorted(v)
            for k, v in ours["calib"].items()}
    print(f"{label}: step-1 loss {ours['loss1']:.6f} against phase 7's {p7['loss1']:.6f} "
          f"(relative {rel:.3e}, limit {HOST_LOSS_RTOL}); calibrated columns per class "
          f"{cols} (phase 7: {cols7}; the same columns: {same}); ms/step "
          f"{ours['step_ms']:.3f} (phase 7: {p7['step_ms']:.3f}), peak "
          f"{ours['peak_gib']:.2f} GiB ({p7['peak_gib']:.2f})")
    if rel > HOST_LOSS_RTOL or cols != cols7:
        raise AssertionError(f"{label}: step-1 loss or calibration differ from phase 7's")


def remat_path(rows, device: str = "cuda", model: str = "large-v3"):
    """Phase 9c: large-v3 full fine-tuning (largev3_debug.config, batch 4)
    under ASR_TPU_REMAT_SAVE=mid, enc and enc+dec and with
    --no-gradient_checkpointing, on phase 6's 20 wavs, no eval, no
    checkpoint. First on plain attention with deterministic algorithms (as
    8b; without remat plain attention's probabilities would not fit), 2
    steps a mode: the losses and grad norms bit-equal across the modes.
    Then on the kernels, 3 steps a mode: ms/step (steps 2-3), peak device
    memory, the device memory a training forward leaves allocated for its
    backward (ordered mid < enc < enc+dec < none), the attention kernels'
    launches (the forward again in the backward under every remat mode);
    step 1's loss bit-equal across the modes, step 2's and the grad norms
    within REMAT_KERNEL_RTOL of "mid"."""
    import torch
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.models.configs import get_config
    from asr_finetune_tpu_torch.training import checkpoint as ckpt_lib

    on_card = device == "cuda"
    label = "remat save points (9c)"
    kept: list = []

    def forward(*a, **k):
        """Device memory a training forward leaves allocated: what the
        backward will read (its kept tensors) and the output."""
        before = torch.cuda.memory_allocated() if on_card else 0
        out = orig_forward(*a, **k)
        if torch.is_grad_enabled():
            kept.append((torch.cuda.memory_allocated() if on_card else 0) - before)
        return out

    cfg = get_config(model)
    n_attn = cfg.encoder_layers + cfg.decoder_layers
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = f"{tmp}/data"
        os.makedirs(data)
        write_audiofolder(data, TRAIN_UTTS)
        plans = [(m, True) for m in ("mid", "enc", "enc+dec")] + [
            (m, False) for m in ("mid", "enc", "enc+dec", "none")]
        for mode, exact in plans:
            steps = REMAT_STEPS_PLAIN if exact else REMAT_STEPS
            argv = ["-c", TRAIN_CONFIG, "--model_type", model, "--device", device,
                    "--no-debug", "--data_mode", "folder", "--dataset_name", data,
                    "--val_split", "0.2", "--max_steps", str(steps), "--eval_steps", str(steps),
                    "--save_steps", str(steps), "--logging_steps", str(steps),
                    "--eval_delay", str(steps + 1), "--output_dir", f"{tmp}/{len(runs)}",
                    *(("--no-gradient_checkpointing",) if mode == "none" else ())]
            orig_save, orig_forward = ckpt_lib.CheckpointManager.save, W.forward
            ckpt_lib.CheckpointManager.save = lambda *a, **k: False   # phase 6 writes one
            W.forward = forward
            kept.clear()
            if mode != "none":
                os.environ["ASR_TPU_REMAT_SAVE"] = mode
            if exact:
                os.environ["ASR_TPU_ATTN_IMPL"] = "xla"
                torch.use_deterministic_algorithms(True, warn_only=True)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            reset_all_launches()
            try:
                _, rec = _recorded_run(argv)
            finally:
                ckpt_lib.CheckpointManager.save, W.forward = orig_save, orig_forward
                torch.use_deterministic_algorithms(False)
                for k in ("ASR_TPU_REMAT_SAVE", "ASR_TPU_ATTN_IMPL"):
                    os.environ.pop(k, None)
            runs[(mode, exact)] = {
                "losses": [s["loss"] for s in rec["steps"]],
                "grad_norms": [s["grad_norm"] for s in rec["steps"]],
                "ms": 1e3 * float(np.mean([s["s"] for s in rec["steps"][1:]])),
                "peak": torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0,
                "kept": max(kept) / 2**30, "launches": all_launches()}
            del rec["state"], rec
            if on_card:
                torch.cuda.empty_cache()

    plain = {m: r for (m, e), r in runs.items() if e}
    kern = {m: r for (m, e), r in runs.items() if not e}
    reading = {"phase": "9c", "model": model, "steps": {"plain": REMAT_STEPS_PLAIN,
                                                        "kernels": REMAT_STEPS},
               "plain": {m: {"losses": r["losses"], "grad_norms": r["grad_norms"],
                             "ms_per_step": r["ms"], "peak_gib": r["peak"]}
                         for m, r in plain.items()},
               "kernels": {m: {"losses": r["losses"], "grad_norms": r["grad_norms"],
                               "ms_per_step": r["ms"], "peak_gib": r["peak"],
                               "forward_kept_gib": r["kept"],
                               "launches": {k: v for k, v in r["launches"].items() if v}}
                           for m, r in kern.items()}}
    print(json.dumps(reading))
    for m, r in kern.items():
        print(f"{label}, {m}: {r['ms']:.3f} ms/step (steps 2-{REMAT_STEPS}), peak "
              f"{r['peak']:.2f} GiB, a forward leaves {r['kept']:.2f} GiB for the "
              f"backward, attention forward {r['launches']['encoder_attention']} "
              f"and backward {r['launches']['encoder_attention_bwd']} launches; losses "
              f"{r['losses']}; plain attention: "
              + (f"{plain[m]['ms']:.3f} ms/step, peak {plain[m]['peak']:.2f} GiB"
                 if m in plain else "not run (plain attention without remat would not fit)"))
    if on_card:
        for what in ("kept", "peak"):
            print(f"{label}: {what} over mid, " + ", ".join(
                f"{m} {kern[m][what] - kern['mid'][what]:+.2f} GiB"
                for m in ("enc", "enc+dec", "none")))
    if any(len(r["losses"]) != (REMAT_STEPS_PLAIN if e else REMAT_STEPS)
           or not all(np.isfinite(r["losses"] + r["grad_norms"])) for (_, e), r in runs.items()):
        raise AssertionError(f"{label}: a run has missing or non-finite steps")
    ref = plain["mid"]
    if any((r["losses"], r["grad_norms"]) != (ref["losses"], ref["grad_norms"])
           for r in plain.values()):
        raise AssertionError(f"{label}: on plain attention the modes' losses or grad norms "
                             "differ")
    k0 = kern["mid"]
    for m, r in kern.items():
        if r["losses"][0] != k0["losses"][0] or any(
                _rel(a, b) > REMAT_KERNEL_RTOL
                for a, b in zip(r["losses"] + r["grad_norms"], k0["losses"] + k0["grad_norms"])):
            raise AssertionError(f"{label}: on the kernels {m} differs from mid beyond "
                                 f"{REMAT_KERNEL_RTOL}")
        fwd = REMAT_STEPS * n_attn * (1 if m == "none" else 2)
        got = (r["launches"]["encoder_attention"], r["launches"]["encoder_attention_bwd"])
        if on_card and got != (fwd, REMAT_STEPS * n_attn):
            raise AssertionError(f"{label}: {m} launched the attention {got}, expected "
                                 f"{(fwd, REMAT_STEPS * n_attn)}")
        if on_card:
            record_launches(rows, f"remat_{m}", r["launches"])
    # what a forward keeps grows with the save points; the peak, reached in
    # the encoder's backward once the decoder's kept tensors are freed, does
    # not tell enc from enc+dec
    if on_card and not (kern["mid"]["kept"] < kern["enc"]["kept"] < kern["enc+dec"]["kept"]
                        < kern["none"]["kept"]):
        raise AssertionError(f"{label}: kept memory not ordered mid < enc < enc+dec < none")
    if on_card and not (kern["mid"]["peak"] < min(kern["enc"]["peak"], kern["enc+dec"]["peak"])
                        <= max(kern["enc"]["peak"], kern["enc+dec"]["peak"])
                        < kern["none"]["peak"]):
        raise AssertionError(f"{label}: peaks not ordered mid < enc, enc+dec < none")


# Phase 10, the last modules of the JAX package: the host C++ path under the
# WER and the collator (10a), cli.classify (10b), cli.verify_parity (10c)

HOST_EDIT_PAIRS = 200       # word pairs for the edit distance
HOST_CORPUS_PAIRS = 2000    # the corpus of corpus_wer
# the collator batch's waveforms: below, at and above the 480,000-sample window
HOST_AUDIO_LENS = (1, 48_000, 160_000, 479_999, 480_000, 480_001, 464_000, 560_000)
HOST_REPS = 21              # timed calls (the median is printed)
HOST_UTT_BATCH = 8          # transcripts of one eval batch (per-utterance WER)
JUDGE_TYPES = 2             # error types the judge scores per transcript
# whisper-small's published widths (models/configs.py): the full-width gauntlet
SMALL_HF = {"vocab_size": 51865, "num_mel_bins": 80, "d_model": 768,
            "encoder_layers": 12, "decoder_layers": 12, "encoder_attention_heads": 12,
            "decoder_attention_heads": 12, "encoder_ffn_dim": 3072,
            "decoder_ffn_dim": 3072, "max_source_positions": 1500,
            "max_target_positions": 448}


def transformers_present() -> bool:
    try:
        import transformers  # noqa: F401
    except ImportError:
        return False
    return True


def _median_ms(fn, reps: int = HOST_REPS) -> float:
    """Median host wall time of fn() over reps calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def host_native_path(eval_final: dict) -> None:
    """Phase 10a: the host C++ path (utils/native_ext, built with g++ at
    first use; build() timed it) against its plain Python versions on seeded
    inputs, exactly: the edit distance over HOST_EDIT_PAIRS word pairs,
    corpus_wer over HOST_CORPUS_PAIRS pairs, the collator's audio batch
    (assemble_batch) bit for bit at B 8 with lengths below and above the
    30 s window. Prints the host times (this machine's CPU, not the card)
    of corpus_wer and of one collator audio batch at B 4 and 8, C++ against
    Python, and of the evaluator's per-utterance WER over a batch of
    HOST_UTT_BATCH transcripts, and asserts that the evaluator phase's corpus
    WER equals the Python WER of its own transcripts."""
    from asr_finetune_tpu_torch.evaluation import wer as wer_lib
    from asr_finetune_tpu_torch.evaluation.normalize import normalize
    from asr_finetune_tpu_torch.ops import logmel
    from asr_finetune_tpu_torch.utils import native_ext

    rng = np.random.default_rng(17)

    def words(lo, hi):
        n = int(rng.integers(lo, hi))
        return [GERMAN_WORDS[int(i)] for i in rng.integers(len(GERMAN_WORDS), size=n)]

    pairs = [(words(0, 16), words(0, 16)) for _ in range(HOST_EDIT_PAIRS)]
    wrong = [(a, b) for a, b in pairs
             if native_ext.edit_distance_words(a, b) != wer_lib._edit_distance(a, b)]
    if wrong:
        raise AssertionError(f"edit distance: C++ != Python on {len(wrong)} pairs, "
                             f"first {wrong[0]}")
    refs = [" ".join(words(1, 31)) for _ in range(HOST_CORPUS_PAIRS)]
    hyps = [" ".join(words(1, 31)) for _ in range(HOST_CORPUS_PAIRS)]

    def corpus_py():
        errors = total = 0
        for r, h in zip(refs, hyps):
            errors += wer_lib._edit_distance(r.split(), h.split())
            total += len(r.split())
        return errors, total

    got, want = native_ext.corpus_wer(refs, hyps), corpus_py()
    if got != want:
        raise AssertionError(f"corpus_wer: C++ {got} != Python {want}")
    audios = [rng.standard_normal(n).astype(np.float32) for n in HOST_AUDIO_LENS]

    def batch_py(a):
        return np.stack([logmel.pad_or_trim(np.asarray(x, np.float32)) for x in a])

    out, ref = native_ext.assemble_batch(audios, logmel.CHUNK_SAMPLES), batch_py(audios)
    if out.dtype != ref.dtype or out.shape != ref.shape \
            or not np.array_equal(out.view(np.uint32), ref.view(np.uint32)):
        raise AssertionError(f"assemble_batch: not bit-equal to pad_or_trim "
                             f"({out.dtype} {out.shape} vs {ref.dtype} {ref.shape})")
    times = {"corpus_wer": (_median_ms(lambda: native_ext.corpus_wer(refs, hyps)),
                            _median_ms(corpus_py))}
    for b in (4, 8):
        times[f"collator audio B{b}"] = (
            _median_ms(lambda: native_ext.assemble_batch(audios[:b], logmel.CHUNK_SAMPLES)),
            _median_ms(lambda: batch_py(audios[:b])))
    refs_e = [normalize(r["original"]) for r in eval_final["results"]]
    hyps_e = [normalize(r["predicted"]) for r in eval_final["results"]]

    def eval_wer_py():
        errors = sum(wer_lib._edit_distance(r.split(), h.split()) for r, h in zip(refs_e, hyps_e))
        return 100.0 * (errors / sum(len(r.split()) for r in refs_e))

    py_wer = eval_wer_py()
    # the WER an evaluation computes over its transcripts, as the evaluator
    # and the trainer's eval call it
    times["evaluator WER"] = (_median_ms(lambda: wer_lib.wer_percent(refs_e, hyps_e)),
                              _median_ms(eval_wer_py))
    # the evaluator's per-utterance WER (evaluation/evaluate.py): one call a
    # transcript, over a batch of HOST_UTT_BATCH seeded pairs with words
    utt = list(zip(refs, hyps))[:HOST_UTT_BATCH]

    def utt_wer_cpp():
        for r, h in utt:
            wer_lib.wer_percent([r], [h])

    def utt_wer_py():
        for r, h in utt:
            100.0 * wer_lib._edit_distance(r.split(), h.split()) / len(r.split())

    times[f"per-utterance WER B{HOST_UTT_BATCH}"] = (_median_ms(utt_wer_cpp),
                                                     _median_ms(utt_wer_py))
    if eval_final["wer"] != py_wer:
        raise AssertionError(f"eval_final.json WER {eval_final['wer']!r} != the Python "
                             f"WER of its transcripts {py_wer!r}")
    print(f"host C++ path (phase 10a): {HOST_EDIT_PAIRS} edit distances, corpus_wer over "
          f"{HOST_CORPUS_PAIRS} pairs and assemble_batch at B {len(audios)} (lengths "
          f"{list(HOST_AUDIO_LENS)}) equal to Python, bit for bit; the evaluator's WER "
          f"{eval_final['wer']!r} equals the Python WER of its transcripts")
    print(f"host C++ path, host times on this machine's CPU (median of {HOST_REPS}; "
          f"corpus_wer over {HOST_CORPUS_PAIRS} pairs on "
          f"{native_ext._wer_threads(0, HOST_CORPUS_PAIRS)} threads, smaller calls and "
          f"the collator inline): " + "; ".join(
              f"{k} C++ {c:.3f} ms, Python {py:.3f} ms" for k, (c, py) in times.items()))
    print(json.dumps({"phase": "10a", "host_ms": {k: {"cpp": c, "python": py}
                                                  for k, (c, py) in times.items()}}))


def write_tiny_judge(path) -> None:
    """A tiny random GPT-2 with a character-level tokenizer, written with
    save_pretrained (transformers and tokenizers): a judge that runs the
    LLM classifier's pipeline end to end (it emits no valid JSON, so every
    score takes the 'unparsbar' form)."""
    import torch
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import GPT2Config, GPT2LMHeadModel, PreTrainedTokenizerFast

    vocab = {"[UNK]": 0, "[PAD]": 1, "<|end|>": 2}
    for ch in [chr(i) for i in range(32, 127)] + list("äöüÄÖÜß"):
        vocab.setdefault(ch, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
                            eos_token="<|end|>").save_pretrained(str(path))
    torch.manual_seed(0)
    cfg = GPT2Config(vocab_size=len(vocab), n_positions=1024, n_embd=32, n_layer=1,
                     n_head=2, eos_token_id=2, pad_token_id=1)
    GPT2LMHeadModel(cfg).save_pretrained(str(path))


def classify_path(eval_final: dict, have_hf: bool) -> None:
    """Phase 10b: cli.classify, rule-based, on the evaluator phase's
    eval_final.json: one CSV row per transcript and error type, the profile
    over every type. With transformers, the LLM judge too, on the card
    (--device cuda) over a tiny GPT-2, JUDGE_TYPES types per transcript."""
    import csv
    import torch
    from asr_finetune_tpu_torch.classify.error_types import (DEFAULT_ERROR_TYPES,
                                                             LLMClassifier)
    from asr_finetune_tpu_torch.cli import classify

    n = len(eval_final["results"])
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/eval_final.json"
        with open(path, "w", encoding="utf-8") as f:
            json.dump(eval_final, f, ensure_ascii=False)

        def run(types, *extra):
            out = f"{tmp}/errors_{len(types)}.csv"
            t0 = time.perf_counter()
            profile = classify.main(["--eval_json", path, "--output_csv", out, *extra])
            wall = time.perf_counter() - t0
            with open(out, newline="", encoding="utf-8") as f:
                rows_csv = list(csv.DictReader(f))
            names = [t.name for t in types]
            want = [(str(i), t) for i in range(n) for t in names]
            if [(r["idx"], r["error_type"]) for r in rows_csv] != want \
                    or sorted(profile) != sorted(names) \
                    or any(r["original"] != eval_final["results"][int(r["idx"])]["original"]
                           for r in rows_csv):
                raise AssertionError(f"cli.classify {list(extra)}: rows "
                                     f"{[(r['idx'], r['error_type']) for r in rows_csv]}, "
                                     f"profile {sorted(profile)}")
            return rows_csv, wall

        rows_csv, wall = run(DEFAULT_ERROR_TYPES)
        print(f"cli.classify (phase 10b), rule-based: {n} transcripts x "
              f"{len(DEFAULT_ERROR_TYPES)} types = {len(rows_csv)} CSV rows, "
              f"{wall:.3f} s (host)")
        if not have_hf:
            print("cli.classify: transformers is absent on this machine; the LLM judge "
                  "did not run")
            return
        write_tiny_judge(f"{tmp}/judge")
        types = DEFAULT_ERROR_TYPES[:JUDGE_TYPES]
        with open(f"{tmp}/types.csv", "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["name", "description"])
            w.writerows([(t.name, t.description) for t in types])
        rows_csv, wall = run(types, "--llm_model_path", f"{tmp}/judge", "--device", "cuda",
                             "--error_types_csv", f"{tmp}/types.csv")
        judge = LLMClassifier(f"{tmp}/judge", max_new_tokens=8, device="cuda")
        where = next(judge.pipe.model.parameters()).device
        if where.type != "cuda":
            raise AssertionError(f"the judge's pipeline runs on {where}")
        del judge
        torch.cuda.empty_cache()
        print(f"cli.classify, LLM judge on {where} (tiny random GPT-2): {n} transcripts x "
              f"{len(types)} types = {len(rows_csv)} CSV rows, {wall:.3f} s")


def write_small_hf_dir(path, seed: int = 0) -> None:
    """A random-init HF Whisper checkpoint at whisper-small's widths
    (SMALL_HF), written with save_pretrained, with a feature extractor; a
    generation config that forces nothing (as tests/test_cli_verify_parity.py
    writes its tiny one) and, as whisper's own, suppresses the special ids
    past <|endoftext|> and, at the first step, " " and <|endoftext|>; and a
    made-up byte-level vocabulary of the 50257 text tokens (the 256 bytes,
    then " a", " b", ... as words) with no merges, so the port's tokenizer
    prompts with the 51865-token layout's special ids and decodes the random
    tokens to words the WER stage can count."""
    import torch
    from transformers import (WhisperConfig, WhisperFeatureExtractor,
                              WhisperForConditionalGeneration)

    from asr_finetune_tpu_torch.models.tokenizer import SpecialTokens, _bytes_to_unicode
    special = SpecialTokens.for_vocab(SMALL_HF["vocab_size"])
    torch.manual_seed(seed)
    m = WhisperForConditionalGeneration(WhisperConfig(**SMALL_HF)).eval()
    m.generation_config.suppress_tokens = list(range(special.eot + 1, SMALL_HF["vocab_size"]))
    m.generation_config.begin_suppress_tokens = [220, special.eot]
    m.generation_config.forced_decoder_ids = None
    m.generation_config.no_timestamps_token_id = special.no_timestamps
    m.save_pretrained(str(path))
    WhisperFeatureExtractor(feature_size=SMALL_HF["num_mel_bins"]).save_pretrained(str(path))
    byte = _bytes_to_unicode()
    vocab = {byte[b]: b for b in range(256)}
    for i in range(special.eot - 256):
        word = ""
        while True:
            i, r = divmod(i, 26)
            word += chr(ord("a") + r)
            if i == 0:
                break
        vocab[byte[ord(" ")] + word] = len(vocab)
    with open(f"{path}/vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(f"{path}/merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")


def verify_parity_path(have_hf: bool) -> None:
    """Phase 10c: cli.verify_parity at whisper-small's widths on the card
    (--device cuda --rows 2 --max_length 24 --beams 4): every stage must
    pass and the decodes must have run the fused decoder kernels. Without
    transformers, the CLI must raise ImportError naming it."""
    from asr_finetune_tpu_torch.cli import verify_parity

    argv = ["--device", "cuda", "--rows", "2", "--max_length", "24", "--beams", "4"]
    if not have_hf:
        try:
            verify_parity.main(["--hf_dir", "absent", *argv])
        except ImportError as e:
            if "transformers" not in str(e):
                raise
            print(f"cli.verify_parity (phase 10c): transformers is absent on this machine, "
                  f"the gauntlet did not run (ImportError: {e})")
            return
        raise AssertionError("cli.verify_parity ran without transformers")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_small_hf_dir(f"{tmp}/hf")
        written = time.perf_counter() - t0
        reset_all_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = verify_parity.main(["--hf_dir", f"{tmp}/hf", *argv])
        wall = time.perf_counter() - t0
        launches = all_launches()
    print(out.getvalue(), end="")
    if rc != 0:
        raise AssertionError(f"cli.verify_parity at whisper-small widths: exit {rc}")
    used = ("encoder_attention", "fused_qkv", "fused_attn_self", "fused_attn_beam", "fused_mlp")
    if not all(launches[k] > 0 for k in used):
        raise AssertionError(f"cli.verify_parity: kernels not launched {launches}")
    print(f"cli.verify_parity (phase 10c), whisper-small widths (d 768, 12+12 layers, vocab "
          f"51865), random init: every stage passed, {wall:.1f} s (checkpoint written in "
          f"{written:.1f} s); launches {json.dumps({k: v for k, v in launches.items() if v})}")


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
        # layer the qkv kernel once per pass of up to 32 rows; the
        # cross-attention's q product, attention core (with its combine) and
        # wo once per pass of attn_passes, and so the self-attention's or
        # the beam self-attention's core and wo; the MLP's fc1 and fc2
        # kernels once per pass of up to 32 rows; no GEMV, partial or
        # combine kernel (the fp32 route's)
        DF.reset_kernel_launches()
        for _ in range(4):
            step()
        torch.cuda.synchronize()
        per_step = {k: v / 4 for k, v in DF.kernel_launches().items()}
        cross_p, self_p = len(DF.attn_passes(n, group)), len(DF.attn_passes(n))
        want = {"gemv_kernel": 0, "qkv_kernel": -(-n // 32) * L,
                "attn_partial_kernel": 0, "attn_combine_kernel": 0,
                "mlp_fc1_kernel": -(-n // 32) * L, "mlp_fc2_kernel": -(-n // 32) * L,
                "attn_q_kernel": cross_p * L, "attn_chunk_kernel": (cross_p + self_p) * L,
                "attn_wo_kernel": (cross_p + self_p) * L}
        print(f"decode step {name}: CUDA kernel launches per step {per_step}")
        if per_step != want:
            raise AssertionError(f"decode step {name}: kernel launches {per_step} != {want}")
        del cache, scratch
    del params, ckv, ckv8
    torch.cuda.empty_cache()


def greedy_graph_path(rows):
    """Phase 5c: greedy decode on the main path, one position replayed as a
    CUDA graph (evaluation/decode.py), against the host loop:
    whisper-large-v3 (32+32 layers, bf16, random init, the decoder's
    position table drawn at std 2 so that the tokens change from position to
    position), cap 128, at 32 rows and a partial batch of 5, and at 32 rows
    with int8 cross K/V and decoder weights: tokens and lengths bit-equal,
    one capture, replays = positions - eager positions, the decoder kernels'
    launch counts the host loop's; the wall time of a batch both ways. Then
    kernel-table rows 2 and 3 with the position on the card against the int
    position (B 4, cache 128, pos 63, the calls cycling through the 32
    layers, float and mixed weights): the same bits, device time by graph
    replay."""
    import torch
    from asr_finetune_tpu_torch.evaluation import decode as D_
    from asr_finetune_tpu_torch.models import whisper as W
    from asr_finetune_tpu_torch.models.configs import get_config
    from asr_finetune_tpu_torch.ops import decoder_fused as DF
    from asr_finetune_tpu_torch.ops import quant as Q

    cfg = get_config("large-v3")
    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    params = W.cast_matmul_weights_(W.init_params(cfg, seed=0, device=dev), bf16)
    g = torch.Generator(device=dev).manual_seed(5)
    table = params["decoder"]["pos"]
    table.copy_((torch.randn(table.shape, generator=g, device=dev) * 2.0).to(bf16))
    forced = [cfg.sot_token_id, cfg.first_language_token_id, cfg.transcribe_token_id,
              cfg.no_timestamps_token_id]
    mels = torch.randn((32, 3000, cfg.num_mel_bins), generator=g, device=dev)
    graphed = D_.uses_graph

    def run(mel, graph, kw):
        D_.uses_graph = graphed if graph else (lambda *a: False)
        try:
            DF.reset_kernel_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = D_.greedy_decode(params, mel, cfg, forced, 128, bf16, **kw)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, DF.kernel_launches()
        finally:
            D_.uses_graph = graphed

    for n, kw in ((32, {}), (5, {}), (32, dict(kv_int8=True, w_int8=True))):
        mel = mels[:n]
        label = f"greedy graph, large-v3 {n} rows" + (" int8 K/V and weights" if kw else "")
        run(mel, False, kw)   # warm-up
        ref, eager_s, eager_k = run(mel, False, kw)
        D_.release_graphs()
        D_.reset_graph_counters()
        first, first_s, _ = run(mel, True, kw)
        again, again_s, again_k = run(mel, True, kw)
        counts = D_.graph_counters()
        for out in (first, again):
            if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
                bad = int((out[0] != ref[0]).any(dim=1).sum())
                raise AssertionError(f"{label}: replayed tokens differ from the host "
                                     f"loop's in {bad} rows")
        toks = ref[0].cpu()
        last = 0
        for row in toks.tolist():
            hits = [i for i, t in enumerate(row[len(forced):]) if t == cfg.eos_token_id]
            last = max(last, len(forced) + hits[0] if hits else 128)
        positions = min(127, last)
        want = {"captures": 1, "replays": 2 * (positions - len(forced)),
                "eager_positions": 2 * len(forced)}
        if counts != want or again_k != eager_k:
            raise AssertionError(f"{label}: counters {counts} (want {want}), kernel launches "
                                 f"{again_k} (host loop {eager_k})")
        print(f"{label}: replayed tokens == host loop's ({positions} positions, "
              f"{len(set(toks[:, len(forced):].reshape(-1).tolist()))} distinct tokens); "
              f"{json.dumps(counts)}; batch wall: host loop {1e3 * eager_s:.1f} ms, graph "
              f"{1e3 * again_s:.1f} ms (first call, with its capture, {1e3 * first_s:.1f} ms)")
    D_.release_graphs()
    del params, mels
    torch.cuda.empty_cache()

    # kernel-table rows 2 (self fused_attn) and 3 (fused_qkv, its cache form)
    def rn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    ln = (1 + rn(L, D, scale=0.1, dtype=f32), rn(L, D, scale=0.1, dtype=f32))
    w32 = {k: rn(L, D, D, scale=D ** -0.5, dtype=f32) for k in "qkvo"}
    b = {k: rn(L, D, scale=0.1) for k in "qvo"}
    x, q = rn(B, D), rn(B, D, scale=0.125, dtype=f32)
    ck, cv = rn(L, B, SELF_T, D), rn(L, B, SELF_T, D)
    on_card = torch.full((1,), SELF_POS, dtype=torch.long, device=dev)
    for kind, int8 in (("float", ()), ("mixed", ("k", "o"))):
        w = {}
        for k, t in w32.items():
            qw = Q.quantize_weight(t) if k in int8 else None
            w[k] = (t.to(bf16), None) if qw is None else (qw[Q.QUANT_KEY], qw[Q.SCALE_KEY])

        def attn(layer, pos):
            return DF.fused_attn(x, ck, cv, w["o"][0], b["o"], q=q, pos=pos,
                                 wo_scale=w["o"][1], layer_idx=layer)

        def qkv(layer, pos):
            return DF.fused_qkv(x, *ln, w["q"][0], b["q"], w["k"][0], w["v"][0], b["v"],
                                wq_scale=w["q"][1], wk_scale=w["k"][1], wv_scale=w["v"][1],
                                layer_idx=layer, cache_k=ck, cache_v=cv, pos=pos)

        for name, fn in (("fused_attn_self", attn), ("fused_qkv", qkv)):
            int_out = fn(L - 1, SELF_POS)
            int_out = (tuple(t.clone() for t in int_out) if isinstance(int_out, tuple)
                       else int_out.clone())
            if name == "fused_qkv":   # the rows the card form is to write
                ck[L - 1, :, SELF_POS] = 0
                cv[L - 1, :, SELF_POS] = 0
            card_out = fn(L - 1, on_card)
            same = (torch.equal(card_out, int_out) if name == "fused_attn_self"
                    else torch.equal(card_out[0], int_out[0])
                    and torch.equal(ck[L - 1, :, SELF_POS], int_out[1])
                    and torch.equal(cv[L - 1, :, SELF_POS], int_out[2]))
            if not same:
                raise AssertionError(f"{name} ({kind}): the position on the card gives "
                                     "other bits than the int position")
            times = {}
            for form, pos in (("int", SELF_POS), ("card", on_card)):
                it = iter(range(10 ** 9))
                times[form] = device_ms(lambda: fn(next(it) % L, pos), 64)
            row = name + ("_int8" if int8 else "")
            if row in rows:
                rows[row]["ms_position_on_card"] = times["card"]
                rows[row]["ms_int_position"] = times["int"]
            print(f"  {row} [bfloat16] B {B} cache {SELF_T} pos {SELF_POS}: position on the "
                  f"card {times['card']:.4f} ms, int position {times['int']:.4f} ms (device, "
                  f"graph replay; bit-equal)")


def build():
    from asr_finetune_tpu_torch.ops import _build
    from asr_finetune_tpu_torch.utils import native_ext
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built from {_build.CSRC} in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.sources())})")
    built = not native_ext._target().exists()
    t0 = time.perf_counter()
    native_ext.load()
    print(f"host C++ library {native_ext.SOURCE.name} "
          f"{'built with g++' if built else 'found built'} in "
          f"{time.perf_counter() - t0:.2f} s ({native_ext._target().name})")


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
    check_tp_kernels(rows)
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
    greedy_graph_path(rows)
    eval_final = evaluator_path(rows)
    train_main_path(rows)
    train_main_path(rows, config=PEFT_CONFIG, extra=("--int8_matmul",))
    train_main_path(rows, config=PEFT_CONFIG, extra=("--int8_matmul",), fused_qkv=True)
    hpo_main_path(rows)
    hpo_packed_path(rows)
    dp_main_path(rows)
    tp_main_path(rows, peft=False)
    tp_main_path(rows, peft=True)
    offload_path(rows, peft=False)
    offload_path(rows, peft=True)
    spec_augment_path(rows)
    host_logmel_path(rows)
    remat_path(rows)
    have_hf = transformers_present()
    host_native_path(eval_final)
    classify_path(eval_final, have_hf)
    verify_parity_path(have_hf)
    step_breakdown()
    print(json.dumps({"step_device_ms": STEP_DEVICE}))
    for k in ("fused_mlp", "fused_mlp_int8", "fused_qkv", "fused_qkv_int8"):   # every row count
        rows[k + "_r16"]["launches"] = rows[k]["launches"]
        rows[k + "_r16"]["launches_of"] = k
    print(card_line())
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(dp_rank(sys.argv[2]) if sys.argv[1:2] == ["--dp-rank"]
             else tp_rank(sys.argv[2]) if sys.argv[1:2] == ["--tp-rank"]
             else hpo_rank(sys.argv[2]) if sys.argv[1:2] == ["--hpo-rank"] else main())

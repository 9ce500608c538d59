"""Fused log-mel frontend: CUDA kernel (csrc/logmel.cu) + plain version.

Counterpart of asr_finetune_tpu/ops/logmel_pallas.py: replaces the Pallas
kernel `log_mel_pallas` (:123; pl.pallas_call :147, `_kernel` :96). From a
(B, 480000) fp32 waveform the kernel computes, per frame at hop 160 and in
fp32 on the CUDA cores (no TF32), the reflect padding of 200, the
hann-windowed 400-tap real DFT, re² + im², the slaney mel projection and
log10(max(·, 1e-10)); the global (max − 8) floor and (x + 4) / 4 run after it
in PyTorch, as the JAX package runs them in XLA after its Pallas call. The
TPU staging (640-wide rows, phase-folded DFT operands, `pltpu.roll`) is not
ported: the CUDA kernel stages each block's samples in shared memory and
reflects at the ends as it loads. csrc/logmel.cu says how it is laid out;
it is bound by operations (4.5 GFLOP at B 4, 128 mels: 0.067 ms at the
H100's fp32 rate).

No entry point calls this module, as no path of the JAX package calls
`log_mel_pallas`: production computes log-mel as ops/logmel.py's
`log_mel_spectrogram` (the JAX package's XLA form). CUDA tensors launch the
kernel or raise; CPU tensors take `log_mel_fused_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .logmel import CHUNK_SAMPLES, HOP, N_FFT, NUM_FRAMES, _dft_mat, mel_filter_bank

LAUNCHES = {"log_mel": 0}     # wrapper launches on the card (chip_smoke.py reads them)
N_BINS = N_FFT // 2 + 1       # 201
BIN_PAD = 224                 # the kernel's table halves: 201 bins zero-padded to 7 x 32
MAX_MELS = 128


def reset_launches() -> None:
    LAUNCHES["log_mel"] = 0


def log10_mel_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Plain version of the kernel, (B, 480000) fp32 → (B, 3000, n_mels)
    fp32: reflect padding of 200, frames at hop 160 times the (400, 402)
    windowed cos | -sin matrix, re² + im², the slaney filter bank,
    log10(max(·, 1e-10)); unclamped."""
    dev = audio.device
    pad = N_FFT // 2
    x = torch.nn.functional.pad(audio.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)[:, :NUM_FRAMES]              # (B, 3000, 400)
    y = torch.matmul(frames, torch.from_numpy(_dft_mat(N_FFT)).to(dev))
    re, im = y[..., :N_BINS], y[..., N_BINS:]
    mel = torch.matmul(re * re + im * im,
                       torch.from_numpy(mel_filter_bank(n_mels=n_mels)).to(dev))
    return torch.log10(torch.clamp(mel, min=1e-10))


def _normalize(log_spec: torch.Tensor) -> torch.Tensor:
    """Whisper's floor at (global max − 8) over all frames and mel bins of an
    utterance, then (x + 4) / 4."""
    m = log_spec.amax(dim=(1, 2), keepdim=True)
    return (torch.maximum(log_spec, m - 8.0) + 4.0) / 4.0


def log_mel_fused_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """The whole function in plain PyTorch: waveform (B, 480000) →
    log-mel (B, 3000, n_mels), Whisper-normalized."""
    return _normalize(log10_mel_plain(audio, n_mels))


def log_mel_fused(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Waveform (B, 480000) fp32 → log-mel (B, 3000, n_mels),
    Whisper-normalized (the JAX `log_mel_pallas`). CUDA tensors launch the
    kernel for everything before the floor; CPU tensors take the plain
    version."""
    if audio.device.type == "cpu":
        return log_mel_fused_plain(audio, n_mels)
    return _normalize(_log10_mel_cuda(audio, n_mels))


@functools.lru_cache(maxsize=8)
def _tables(n_mels: int, device: torch.device):
    """The kernel's constants on `device`: the (400, 448) DFT table, cos |
    -sin with each half zero-padded to 224 bins, and the (201, n_mels)
    filter bank."""
    dft = np.zeros((N_FFT, 2 * BIN_PAD), np.float32)
    mat = _dft_mat(N_FFT)
    dft[:, :N_BINS], dft[:, BIN_PAD:BIN_PAD + N_BINS] = mat[:, :N_BINS], mat[:, N_BINS:]
    return (torch.from_numpy(dft).to(device),
            torch.from_numpy(mel_filter_bank(n_mels=n_mels)).to(device))


def _log10_mel_cuda(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    if audio.dtype != torch.float32 or audio.dim() != 2 \
            or audio.shape[1] != CHUNK_SAMPLES or not audio.is_contiguous():
        raise ValueError(f"log_mel_fused takes contiguous fp32 (B, {CHUNK_SAMPLES}) "
                         f"audio, got {audio.dtype} {tuple(audio.shape)}")
    if not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"log_mel_fused takes 1..{MAX_MELS} mel bins, got {n_mels}")
    dft, melfb = _tables(n_mels, audio.device)
    B = audio.shape[0]
    out = torch.empty((B, NUM_FRAMES, n_mels), dtype=torch.float32, device=audio.device)
    lib = _lib()
    err = lib.log_mel_fwd(audio.data_ptr(), dft.data_ptr(), melfb.data_ptr(),
                          out.data_ptr(), B, CHUNK_SAMPLES, n_mels,
                          _build.stream_ptr(audio))
    _build.check(lib, err, "log_mel")
    LAUNCHES["log_mel"] += 1
    return out


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("logmel")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.log_mel_fwd.argtypes = [P, P, P, P, I, I, I, P]
        lib.log_mel_fwd.restype = I
        _LIB = lib
    return _LIB

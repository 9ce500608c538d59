"""Fused log-mel frontend: CUDA kernel (csrc/logmel.cu) + plain version.

Counterpart of asr_finetune_tpu/ops/logmel_pallas.py: replaces the Pallas
kernel `log_mel_pallas` (:123; pl.pallas_call :147, `_kernel` :96). From a
(B, 480000) fp32 waveform it computes, per frame at hop 160 and in fp32 on
the CUDA cores, the reflect padding of 200, the hann-windowed 400-tap real
DFT, re² + im², the slaney mel projection, log10(max(·, 1e-10)), and then
Whisper's floor at each utterance's max − 8 and (x + 4) / 4. The TPU staging
(640-wide rows, phase-folded dense DFT operands, `pltpu.roll`) is not
ported. The CUDA kernel runs the DFT as a fast transform in shared memory:
the 200-point complex FFT of z_n = x_2n + i·x_2n+1 in three Stockham passes
of radix 8, 5 and 5 (`RADICES`, `stage_maps`), then the real split to the
201 bins. The mel product sums each filter's nonzero band only
(`mel_bands`). The floor runs in the same call: the kernel folds each
block's max into a per-utterance max, and a second small launch applies the
floor in place. The twiddles, the butterflies' constants and the window come
from one table built in fp64 and rounded once (`fft_table`), uploaded once
per device. csrc/logmel.cu says how it is laid out; the function is bound by
its bytes (`flops_per_frame` counts its operations).

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
from .logmel import CHUNK_SAMPLES, HOP, N_FFT, NUM_FRAMES, device_tables, mel_filter_bank

LAUNCHES = {"log_mel": 0}     # wrapper launches on the card (chip_smoke.py reads them)
N_BINS = N_FFT // 2 + 1       # 201
MAX_MELS = 128
NZ = N_FFT // 2               # 200: the complex FFT of z_n = x_2n + i x_2n+1
RADICES = (8, 5, 5)           # the kernel's Stockham passes, in order
N_PAIRS = NZ // 2 + 1         # the real split's bin pairs (k, 200 - k), k <= 100
# fft_table's layout, in floats: the butterflies' constants (cos 2π/5,
# cos 4π/5, sin 2π/5, sin 4π/5, √½, padding), the twiddles of each pass after
# the first (Ns × (R − 1) complex, q major), the split's W400^k, the window
T_CONST = 0
T_TWIDDLE = 8


def _passes() -> list:
    """(R, Ns) of each Stockham pass: radix R over Ns points already
    transformed."""
    out, ns = [], 1
    for r in RADICES:
        out.append((r, ns))
        ns *= r
    assert ns == NZ
    return out


def _twiddle_offsets() -> list:
    """Each pass's offset in fft_table (floats), None for the first (Ns = 1:
    no twiddles)."""
    out, at = [], T_TWIDDLE
    for r, ns in _passes():
        if ns == 1:
            out.append(None)
        else:
            out.append(at)
            at += 2 * ns * (r - 1)
    return out


T_SPLIT = T_TWIDDLE + sum(2 * ns * (r - 1) for r, ns in _passes() if ns > 1)   # 392
T_WIN = T_SPLIT + 2 * N_PAIRS                                          # 594
TABLE_FLOATS = -(-(T_WIN + N_FFT) // 4) * 4                            # 996


def stage_maps(r: int, ns: int) -> tuple:
    """Index maps of a Stockham pass of radix r over ns transformed points:
    butterfly j (of NZ / r) reads src[j, :], multiplies input s by the
    twiddle exp(-2πi expo[j, s] / (ns r)), runs the r-point DFT and writes
    output s to dst[j, s]. The output is in natural order after the last
    pass; csrc/logmel.cu computes the same maps."""
    j = np.arange(NZ // r)[:, None]
    s = np.arange(r)[None, :]
    src = j + s * (NZ // r)
    dst = (j // ns) * ns * r + j % ns + s * ns
    expo = (j % ns) * s
    return src, dst, expo


def fft_table(dtype=np.float32) -> np.ndarray:
    """The kernel's constants, built in fp64 and rounded once to `dtype`:
    the butterflies' constants, each later pass's twiddles exp(-2πi q s /
    (Ns R)) for q < Ns, 0 < s < R, the real split's exp(-2πi k / 400) for k
    <= 100, and the periodic hann window (re, im interleaved)."""
    t = np.zeros(TABLE_FLOATS, np.float64)
    a = 2.0 * np.pi / 5.0
    t[T_CONST:T_CONST + 5] = [np.cos(a), np.cos(2 * a), np.sin(a), np.sin(2 * a), np.sqrt(0.5)]
    for (r, ns), at in zip(_passes(), _twiddle_offsets()):
        if at is None:
            continue
        q, s = np.meshgrid(np.arange(ns), np.arange(1, r), indexing="ij")
        w = np.exp(-2j * np.pi * q * s / (ns * r)).reshape(-1)
        t[at:at + 2 * w.size:2], t[at + 1:at + 2 * w.size:2] = w.real, w.imag
    w = np.exp(-2j * np.pi * np.arange(N_PAIRS) / N_FFT)
    t[T_SPLIT:T_WIN:2], t[T_SPLIT + 1:T_WIN:2] = w.real, w.imag
    t[T_WIN:T_WIN + N_FFT] = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    return t.astype(dtype)


def mel_bands(n_mels: int) -> tuple:
    """The slaney bank as bands: int32 [lo_0 .. lo_{M-1}, off_0 .. off_M]
    and fp32 values, mel m's nonzeros fb[lo_m + t, m] at values[off_m + t]
    for t < off_{m+1} - off_m (a contiguous band of bins; an empty filter
    has none)."""
    fb = mel_filter_bank(n_mels=n_mels)
    lo, off, vals = [], [0], []
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        a, z = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        lo.append(a)
        vals.extend(fb[a:z, m])
        off.append(len(vals))
    return np.array(lo + off, np.int32), np.array(vals, np.float32)


def flops_per_frame(n_mels: int) -> int:
    """Operations of one frame as the kernel runs it (adds, multiplies,
    max and log10 each one): the window, the passes' twiddles (6 a complex
    product) and butterflies (8-point 56, 5-point 48), the real split (24 a
    bin pair), the band sums (2 a nonzero), log10 and max (2 a mel) and the
    floor's max, add and divide (3 a mel)."""
    butterfly = {8: 56, 5: 48}
    ops = N_FFT
    for r, ns in _passes():
        ops += NZ // r * (butterfly[r] + (6 * (r - 1) if ns > 1 else 0))
    return ops + 24 * N_PAIRS + 2 * int(mel_bands(n_mels)[1].size) + 5 * n_mels


def reset_launches() -> None:
    LAUNCHES["log_mel"] = 0


def log10_mel_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Plain version of the kernel, (B, 480000) fp32 → (B, 3000, n_mels)
    fp32: reflect padding of 200, frames at hop 160 times the (400, 402)
    windowed cos | -sin matrix, re² + im², the slaney filter bank,
    log10(max(·, 1e-10)); unclamped."""
    dft, melfb = device_tables(n_mels, audio.device)
    pad = N_FFT // 2
    x = torch.nn.functional.pad(audio.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)[:, :NUM_FRAMES]              # (B, 3000, 400)
    y = torch.matmul(frames, dft)
    re, im = y[..., :N_BINS], y[..., N_BINS:]
    return torch.log10(torch.clamp(torch.matmul(re * re + im * im, melfb), min=1e-10))


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
    kernel, floor included; CPU tensors take the plain version."""
    if audio.device.type == "cpu":
        return log_mel_fused_plain(audio, n_mels)
    return _log_mel_cuda(audio, n_mels, normalize=True)


@functools.lru_cache(maxsize=8)
def _tables(n_mels: int, device: torch.device) -> tuple:
    """The kernel's constants on `device`: fft_table in fp32, and the
    bands' int32 index and fp32 values."""
    idx, vals = mel_bands(n_mels)
    return tuple(torch.from_numpy(a).to(device) for a in (fft_table(), idx, vals))


_WORKSPACE: dict = {}


def _workspace(device: torch.device, B: int) -> torch.Tensor:
    """The floor's int32 workspace per device and batch: a block ticket (0
    when idle), each utterance's running max as the float's order-preserving
    integer image (INT_MIN when idle), and each frame block's raw minimum.
    The floor launch's last block puts the ticket and the maxima back, so
    every call, and every replay of a captured call, starts from the idle
    state. Calls on one device share it: they must run in stream order."""
    key = (device, B)
    if key not in _WORKSPACE:
        ws = torch.zeros(_lib().log_mel_workspace_ints(B), dtype=torch.int32)
        ws[1:1 + B] = -2 ** 31
        _WORKSPACE[key] = ws.to(device)
    return _WORKSPACE[key]


def _log10_mel_cuda(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The kernel's log10 mel power alone (one launch, no floor)."""
    return _log_mel_cuda(audio, n_mels, normalize=False)


def _log_mel_cuda(audio: torch.Tensor, n_mels: int, normalize: bool) -> torch.Tensor:
    if audio.dtype != torch.float32 or audio.dim() != 2 \
            or audio.shape[1] != CHUNK_SAMPLES or not audio.is_contiguous():
        raise ValueError(f"log_mel_fused takes contiguous fp32 (B, {CHUNK_SAMPLES}) "
                         f"audio, got {audio.dtype} {tuple(audio.shape)}")
    if audio.data_ptr() % 16:
        raise ValueError("log_mel_fused reads the audio in 16-byte pieces: its "
                         "storage must start 16-byte aligned")
    if not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"log_mel_fused takes 1..{MAX_MELS} mel bins, got {n_mels}")
    table, bands, vals = _tables(n_mels, audio.device)
    B = audio.shape[0]
    ws = _workspace(audio.device, B).data_ptr() if normalize else None
    out = torch.empty((B, NUM_FRAMES, n_mels), dtype=torch.float32, device=audio.device)
    lib = _lib()
    err = lib.log_mel_fwd(audio.data_ptr(), table.data_ptr(), bands.data_ptr(),
                          vals.data_ptr(), out.data_ptr(), ws, B, CHUNK_SAMPLES, n_mels,
                          table.numel(), _build.stream_ptr(audio))
    _build.check(lib, err, "log_mel")
    LAUNCHES["log_mel"] += 1
    return out


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("logmel")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.log_mel_fwd.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
        lib.log_mel_fwd.restype = I
        lib.log_mel_workspace_ints.argtypes = [I]
        lib.log_mel_workspace_ints.restype = I
        _LIB = lib
    return _LIB

"""Whisper log-mel frontend in PyTorch (counterpart of asr_finetune_tpu/ops/logmel.py).

The JAX package computes it in XLA (`log_mel_spectrogram`, :101-168), not in
a Pallas kernel, so this is plain PyTorch in fp32: reflect padding of 200,
the hann-windowed 400-tap real DFT at hop 160 as one product of the framed
audio with a (400, 402) cos|sin matrix, power, slaney mel projection,
log10(max(., 1e-10)), the global (max - 8) floor and (x + 4) / 4. Output is
time-major (B, 3000, n_mels), the layout the encoder consumes. On the card
fp32 products stay fp32 (device.resolve_device turns TF32 off).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
CHUNK_SAMPLES = 30 * SAMPLE_RATE  # 480_000
NUM_FRAMES = CHUNK_SAMPLES // HOP  # 3000


def hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) * logstep,
                    mels)


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freq)


def mel_filter_bank(n_freqs: int = N_FFT // 2 + 1, n_mels: int = 80,
                    fmin: float = 0.0, fmax: float = 8000.0,
                    sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filters, (n_freqs, n_mels)."""
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    filter_freqs = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]  # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    enorm = 2.0 / (filter_freqs[2 : n_mels + 2] - filter_freqs[:n_mels])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic hann window (torch.hann_window(periodic=True) semantics)."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_mat(n_fft: int) -> np.ndarray:
    """Windowed real-DFT matrix (n_fft, 2 * (n_fft//2 + 1)): cos | -sin."""
    k = np.arange(n_fft // 2 + 1)
    t = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(t, k) / n_fft
    w = hann_window(n_fft)[:, None].astype(np.float64)
    cos_m = (np.cos(ang) * w).astype(np.float32)
    sin_m = (-np.sin(ang) * w).astype(np.float32)
    return np.concatenate([cos_m, sin_m], axis=1)


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80,
                        global_norm: bool = True) -> torch.Tensor:
    """Waveform (B, 480000) float32 → log-mel features (B, 3000, n_mels)."""
    dev = audio.device
    filt = torch.from_numpy(_dft_mat(N_FFT)).to(dev)             # (400, 402)
    mel_m = torch.from_numpy(mel_filter_bank(n_mels=n_mels)).to(dev)
    pad = N_FFT // 2
    x = torch.nn.functional.pad(audio.float()[:, None, :], (pad, pad),
                                mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)[:, :NUM_FRAMES]           # (B, 3000, 400)
    y = torch.matmul(frames, filt)                               # (B, 3000, 402)
    nf = N_FFT // 2 + 1
    re, im = y[..., :nf], y[..., nf:]
    power = re * re + im * im
    mel = torch.matmul(power, mel_m)                             # (B, T, n_mels)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    if global_norm:
        # Whisper clamps to (global max - 8) over ALL frames and mel bins
        m = log_spec.amax(dim=(1, 2), keepdim=True)
        log_spec = torch.maximum(log_spec, m - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(audio: np.ndarray, length: int = CHUNK_SAMPLES) -> np.ndarray:
    """Host-side: pad with zeros / truncate to the fixed 30 s window."""
    if audio.shape[-1] >= length:
        return audio[..., :length]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
    return np.pad(audio, pad)

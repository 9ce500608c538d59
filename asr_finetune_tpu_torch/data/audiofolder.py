"""WAV reading for the port (counterpart of asr_finetune_tpu/data/audiofolder.py).

Only `read_wav` is on the ported transcription path; it is a copy of the
JAX package's self-contained PCM/float WAV reader (16/24/32-bit int and
float32, downmix to mono, linear resampling to 16 kHz).
"""
from __future__ import annotations

import wave

import numpy as np

SAMPLE_RATE = 16_000


def read_wav(path: str, target_rate: int = SAMPLE_RATE) -> np.ndarray:
    """PCM/float WAV → mono float32 in [-1, 1] at target_rate."""
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # could be int32 or float32; WAVE_FORMAT tag isn't exposed by `wave`,
        # so sniff: float32 audio stays within [-1, 1]
        as_f = np.frombuffer(raw, "<f4")
        if np.isfinite(as_f).all() and np.abs(as_f).max(initial=0.0) <= 4.0:
            x = as_f.astype(np.float32)
        else:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    if rate != target_rate:
        n_out = int(round(len(x) * target_rate / rate))
        x = np.interp(np.linspace(0, len(x) - 1, n_out),
                      np.arange(len(x)), x).astype(np.float32)
    return x.astype(np.float32)

"""Audiofolder datasets for the port (counterpart of asr_finetune_tpu/data/audiofolder.py).

Directories of .wav files plus a metadata.csv (HF `audiofolder`
convention). A copy of the JAX package's module: the self-contained
PCM/float WAV reader `read_wav` (16/24/32-bit int and float32, downmix to
mono, linear resampling to 16 kHz) and `AudioFolderReader`, which presents
the (idx, audio, text) read API the data pipeline expects.
"""
from __future__ import annotations

import csv
import logging
import os
import wave
from typing import List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

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


class AudioFolderReader:
    """Reader over one or more audiofolder dirs (wavs + metadata.csv).

    metadata.csv columns: file_name,transcription (a `sentence` or `text`
    column is accepted too). Bad wavs are dropped from a read with a
    warning, as the HDF5 reader drops bad rows."""

    TEXT_COLUMNS = ("transcription", "sentence", "text")

    def __init__(self, folders: Sequence[str]):
        if isinstance(folders, str):
            folders = [folders]
        self.items: List[Tuple[str, str]] = []
        for folder in folders:
            meta = os.path.join(folder, "metadata.csv")
            if not os.path.exists(meta):
                raise FileNotFoundError(meta)
            with open(meta, newline="", encoding="utf-8") as f:
                rows = list(csv.DictReader(f))
            if not rows:
                continue
            text_col = next((c for c in self.TEXT_COLUMNS if c in rows[0]), None)
            if text_col is None:
                raise ValueError(f"{meta}: no transcription column "
                                 f"(have {list(rows[0])})")
            for r in rows:
                self.items.append((os.path.join(folder, r["file_name"]),
                                   r[text_col]))
        logger.info("audiofolder: %d utterances from %d folder(s)",
                    len(self.items), len(folders))

    def __len__(self) -> int:
        return len(self.items)

    def transcript_lengths(self) -> np.ndarray:
        """group_by_length sort key (transcript char counts)."""
        return np.asarray([len(t) for _, t in self.items], np.int32)

    def read(self, indices: Sequence[int]) -> List[Tuple[int, np.ndarray, str]]:
        out = []
        for i in indices:
            path, text = self.items[int(i)]
            try:
                out.append((int(i), read_wav(path), text))
            except Exception as e:  # noqa: BLE001 — drop bad rows like hdf5.py
                logger.warning("dropping bad wav %s: %s", path, e)
        return out

"""HDF5 audio reading for the port (counterpart of asr_finetune_tpu/data/hdf5.py).

An `audio` dataset of variable-length float32 waveforms plus a
`transcription` dataset of strings, read per index, bad rows dropped with a
warning. `h5py` is imported only when a file is opened: the machine with
the card may not have it, and only .h5 inputs need it. With copy_to_local
(--copy_to_local) the file is first staged into the temp dir, as the JAX
reader's `_copy_to_local` does for slow network filesystems.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class Hdf5AudioReader:
    """Handle over an HDF5 file of (audio, transcription) rows, opened at
    first read."""

    def __init__(self, path: str, copy_to_local: bool = False):
        self.path = self._copy_to_local(path) if copy_to_local else path
        self._file = None

    @staticmethod
    def _copy_to_local(path: str) -> str:
        """The file staged into the temp dir (under its own name), unless a
        copy of the same size is there already; returns the staged path."""
        local = os.path.join(tempfile.gettempdir(), os.path.basename(path))
        if not os.path.exists(local) or os.path.getsize(local) != os.path.getsize(path):
            logger.info("staging %s -> %s", path, local)
            shutil.copyfile(path, local)
        return local

    @property
    def file(self):
        if self._file is None:
            import h5py
            self._file = h5py.File(self.path, "r")
        return self._file

    def __len__(self) -> int:
        return len(self.file["audio"])

    def read(self, indices: Sequence[int]) -> List[Tuple[int, np.ndarray, str]]:
        """Read rows; bad rows are dropped with a warning."""
        out = []
        f = self.file
        audio_ds, text_ds = f["audio"], f["transcription"]
        for idx in indices:
            try:
                audio = np.asarray(audio_ds[idx], dtype=np.float32)
                text = text_ds[idx]
                if isinstance(text, bytes):
                    text = text.decode("utf-8")
                out.append((int(idx), audio, str(text)))
            except (OSError, KeyError, ValueError, UnicodeDecodeError) as e:
                logger.warning("dropping bad row %d: %s", idx, e)
        return out

    def transcript_lengths(self) -> np.ndarray:
        """Per-row transcript char counts, the group_by_length sort key."""
        return np.asarray([len(t) for t in self.file["transcription"][...]],
                          np.int32)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def write_hdf5_dataset(path: str, audios: Sequence[np.ndarray],
                       transcripts: Sequence[str]) -> None:
    """Write rows in the layout Hdf5AudioReader (and the JAX package's
    reader) reads: `audio` as variable-length float32, `transcription` as
    UTF-8 strings."""
    import h5py
    if len(audios) != len(transcripts):
        raise ValueError(f"{len(audios)} audios vs {len(transcripts)} transcripts")
    with h5py.File(path, "w") as f:
        vlen_f32 = h5py.special_dtype(vlen=np.dtype("float32"))
        ds = f.create_dataset("audio", (len(audios),), dtype=vlen_f32)
        for i, a in enumerate(audios):
            ds[i] = np.asarray(a, np.float32)
        text_dt = h5py.string_dtype(encoding="utf-8")
        f.create_dataset("transcription", data=list(transcripts), dtype=text_dt)


def make_synthetic_dataset(path: str, n: int = 32, seed: int = 0,
                           min_sec: float = 1.0, max_sec: float = 8.0,
                           sample_rate: int = 16000) -> None:
    """n seeded utterances (a mixture of three sines and a little noise)
    with pseudo-German transcripts; the same rows as the JAX package's
    make_synthetic_dataset for the same arguments."""
    rng = np.random.default_rng(seed)
    words = ["der", "die", "das", "und", "haus", "hund", "katze", "läuft",
             "springt", "heute", "morgen", "zeit", "geschichte", "erinnerung"]
    audios, texts = [], []
    for _ in range(n):
        dur = rng.uniform(min_sec, max_sec)
        t = np.arange(int(dur * sample_rate)) / sample_rate
        freqs = rng.uniform(80, 2000, size=3)
        sig = sum(np.sin(2 * np.pi * f * t) * rng.uniform(0.05, 0.3) for f in freqs)
        sig += rng.standard_normal(t.shape) * 0.01
        audios.append(sig.astype(np.float32))
        texts.append(" ".join(rng.choice(words, rng.integers(2, 9))))
    write_hdf5_dataset(path, audios, texts)

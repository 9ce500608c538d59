"""HDF5 audio reading for the port (counterpart of asr_finetune_tpu/data/hdf5.py).

An `audio` dataset of variable-length float32 waveforms plus a
`transcription` dataset of strings, read per index, bad rows dropped with a
warning. `h5py` is imported only when a file is opened: the machine with
the card may not have it, and only .h5 inputs need it.
"""
from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class Hdf5AudioReader:
    """Handle over an HDF5 file of (audio, transcription) rows, opened at
    first read."""

    def __init__(self, path: str):
        self.path = path
        self._file = None

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

"""Parquet feature shards: materialization and reading (PyTorch port).

A copy of asr_finetune_tpu/data/parquet.py, in the same file format, so
either package reads the other's shards:
- `materialize_hdf5_to_parquet` turns a reader's (idx, audio, text) rows
  into shards of precomputed features: per row "idx", "input_features"
  (the host float64 log-mel of the 30 s window, flattened float32),
  "labels" (sot-stripped, padded with -100 to max_label_len), "text",
  "n_frames" and "n_mels";
- `ParquetFeatureReader` reads a shard directory (or one file) back as
  mel / labels / text rows, with the labels' true lengths for the sampler;
- `ParquetCollator` is the pipeline's pass-through reader and collator of
  those rows: the decoder inputs are the labels shifted right behind sot.

pyarrow is imported where a shard is written or read, never when the
module is imported: the card's machine has no pyarrow, and there a parquet
data mode raises ImportError naming it (`require_pyarrow`).
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops import logmel as logmel_ops
from .collator import IGNORE_ID


def require_pyarrow():
    """(pyarrow, pyarrow.parquet), or ImportError naming what is missing."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("the parquet data modes and cli.materialize need pyarrow, "
                          f"which this machine does not have ({e})") from e
    return pa, pq


def materialize_hdf5_to_parquet(reader, tokenizer, out_dir: str,
                                n_mels: int = 80, language: str = "de",
                                task: str = "transcribe",
                                max_label_len: int = 448,
                                shard_size: int = 256,
                                limit: Optional[int] = None,
                                start: int = 0,
                                end: Optional[int] = None) -> List[str]:
    """Precompute (mel, labels) rows of `reader` into parquet shards named
    shard-<first row>.parquet under out_dir; returns their paths. [start,
    end) bounds the rows, so several processes can split one file."""
    pa, pq = require_pyarrow()
    os.makedirs(out_dir, exist_ok=True)
    n = len(reader) if limit is None else min(limit, len(reader))
    end = n if end is None else min(end, n)
    sp = tokenizer.special
    files = []
    for shard_start in range(start, end, shard_size):
        idx = list(range(shard_start, min(shard_start + shard_size, end)))
        feats, labels_col, texts, idxs = [], [], [], []
        for i, audio, text in reader.read(idx):
            mel = logmel_ops.log_mel_np(logmel_ops.pad_or_trim(audio), n_mels)
            lab = tokenizer.build_labels(text, language, task)[:max_label_len]
            if lab and lab[0] == sp.sot:
                lab = lab[1:]               # stored sot-stripped, as training labels
            lab = lab + [IGNORE_ID] * (max_label_len - len(lab))
            feats.append(mel.astype(np.float32).reshape(-1))
            labels_col.append(np.asarray(lab, np.int32))
            texts.append(text)
            idxs.append(i)
        if not feats:
            continue
        table = pa.table({
            "idx": pa.array(idxs, pa.int32()),
            "input_features": pa.array(feats, pa.list_(pa.float32())),
            "labels": pa.array(labels_col, pa.list_(pa.int32())),
            "text": pa.array(texts, pa.string()),
            "n_frames": pa.array([logmel_ops.NUM_FRAMES] * len(feats), pa.int32()),
            "n_mels": pa.array([n_mels] * len(feats), pa.int32()),
        })
        path = os.path.join(out_dir, f"shard-{shard_start:08d}.parquet")
        pq.write_table(table, path)
        files.append(path)
    return files


class ParquetFeatureReader:
    """Materialized feature shards (a directory of *.parquet, or one file),
    loaded whole at first use; rows are numbered across the shards in file
    name order."""

    def __init__(self, path_or_dir: str):
        require_pyarrow()
        if os.path.isdir(path_or_dir):
            self.files = sorted(glob.glob(os.path.join(path_or_dir, "*.parquet")))
        else:
            self.files = [path_or_dir]
        if not self.files:
            raise FileNotFoundError(f"no parquet shards under {path_or_dir}")
        self._tables = None
        self._offsets = None

    def _load(self):
        if self._tables is None:
            _, pq = require_pyarrow()
            self._tables = [pq.read_table(f) for f in self.files]
            self._offsets = np.cumsum([0] + [t.num_rows for t in self._tables])
        return self._tables

    def __len__(self) -> int:
        self._load()
        return int(self._offsets[-1])

    def transcript_lengths(self) -> np.ndarray:
        """The length grouping's key: each row's label count without the
        -100 padding the materializer wrote."""
        out = []
        for t in self._load():
            for row in t["labels"]:
                out.append(int((np.asarray(row.as_py(), np.int32) != IGNORE_ID).sum()))
        return np.asarray(out, np.int32)

    def read_features(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Rows → {"mel" (B, n_frames, n_mels) float32, "labels" (B, L)
        int32, "text" (B,) object}."""
        tables = self._load()
        mels, labels, texts = [], [], []
        for gi in indices:
            ti = int(np.searchsorted(self._offsets, gi, side="right") - 1)
            ri = int(gi - self._offsets[ti])
            t = tables[ti]
            shape = (t["n_frames"][ri].as_py(), t["n_mels"][ri].as_py())
            mels.append(np.asarray(t["input_features"][ri].as_py(),
                                   np.float32).reshape(shape))
            labels.append(np.asarray(t["labels"][ri].as_py(), np.int32))
            texts.append(t["text"][ri].as_py())
        return {"mel": np.stack(mels), "labels": np.stack(labels),
                "text": np.asarray(texts, dtype=object)}


class ParquetCollator:
    """Sampler indices → a batch of materialized features. As the pipeline's
    reader it passes the indices through (`read`); as its collator it
    reads the rows and builds the decoder inputs: sot, then the labels
    shifted right with their -100 padding as pad."""

    def __init__(self, reader: ParquetFeatureReader, sot: int, pad: int):
        self.reader = reader
        self.sot = sot
        self.pad = pad

    def read(self, indices):
        return indices

    def __call__(self, indices) -> Dict[str, np.ndarray]:
        data = self.reader.read_features(list(indices))
        labels = data["labels"]
        B, L = labels.shape
        dec_in = np.full((B, L), self.pad, np.int32)
        dec_in[:, 0] = self.sot
        shifted = labels[:, :-1]
        dec_in[:, 1:] = np.where(shifted == IGNORE_ID, self.pad, shifted)
        return {"mel": data["mel"], "labels": labels,
                "decoder_input_ids": dec_in, "text": data["text"],
                "idx": np.asarray(list(indices), np.int32)}

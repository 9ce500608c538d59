"""Batch assembly: padding, label masking, decoder-input shifting.

A copy of asr_finetune_tpu/data/collator.py for the port:
- labels padded to fixed buckets (48, 96, 192, 448 tokens, so the step
  sees a bounded set of shapes) and pad positions masked to -100;
- the leading <|startoftranscript|> stripped when every row begins with it
  (the shifted decoder inputs re-add it);
- decoder inputs: sot, then the labels shifted right, pad-filled;
- raw audio out, padded or trimmed to the 30 s window (log-mel runs on the
  device); `features="host"` is not ported (it needs the host float64
  log-mel).

The JAX package's optional C++ batch assembly (utils/native_ext) is not
carried over: audio goes through the numpy `pad_or_trim`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..models.tokenizer import WhisperTokenizerBase
from ..ops import logmel as logmel_ops

IGNORE_ID = -100
LABEL_BUCKETS = (48, 96, 192, 448)


@dataclasses.dataclass
class CollatorConfig:
    features: str = "audio"        # "audio" only (on-device mel)
    n_mels: int = 80
    language: str = "de"
    task: str = "transcribe"
    max_label_len: int = 448
    label_buckets: Tuple[int, ...] = LABEL_BUCKETS
    strip_leading_sot: bool = True

    def __post_init__(self):
        if self.features != "audio":
            raise NotImplementedError(
                f"collator features {self.features!r}: host log-mel is not "
                "ported (the port computes log-mel on the device)")


class Collator:
    """(audio, text) rows → model-ready numpy batch."""

    def __init__(self, tokenizer: WhisperTokenizerBase, cfg: CollatorConfig):
        self.tokenizer = tokenizer
        self.cfg = cfg

    def _bucket_len(self, longest: int) -> int:
        for b in self.cfg.label_buckets:
            if longest <= b:
                return b
        return self.cfg.max_label_len

    def __call__(self, rows: Sequence[Tuple[int, np.ndarray, str]]
                 ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        sp = self.tokenizer.special
        B = len(rows)
        audio = np.stack([logmel_ops.pad_or_trim(np.asarray(a, np.float32))
                          for _, a, _ in rows])
        label_lists: List[List[int]] = [
            self.tokenizer.build_labels(t, cfg.language, cfg.task)[: cfg.max_label_len]
            for _, _, t in rows
        ]
        # strip the leading sot when every row starts with it
        if cfg.strip_leading_sot and all(l and l[0] == sp.sot for l in label_lists):
            label_lists = [l[1:] for l in label_lists]

        longest = max(len(l) for l in label_lists)
        L = self._bucket_len(longest)
        labels = np.full((B, L), IGNORE_ID, np.int32)
        dec_in = np.full((B, L), sp.pad, np.int32)
        dec_in[:, 0] = sp.sot
        for i, l in enumerate(label_lists):
            l = l[:L]
            labels[i, : len(l)] = l
            dec_in[i, 1 : min(len(l), L - 1) + 1] = l[: L - 1]

        return {
            "decoder_input_ids": dec_in,
            "labels": labels,
            "idx": np.asarray([i for i, _, _ in rows], np.int32),
            "audio": audio,
            "text": np.asarray([t for _, _, t in rows], dtype=object),
        }

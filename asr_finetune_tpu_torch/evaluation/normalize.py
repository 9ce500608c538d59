"""Transcript normalization (a copy of asr_finetune_tpu/evaluation/normalize.py).

strip, lowercase, remove the characters !?.,; — applied to predictions and
references before WER, bug-for-bug as the reference fine-tuning scripts,
so WER numbers are comparable.
"""
from __future__ import annotations

_REMOVE = "!?.,;"
_TABLE = str.maketrans("", "", _REMOVE)


def normalize(text: str) -> str:
    return text.strip().lower().translate(_TABLE)


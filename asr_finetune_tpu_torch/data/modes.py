"""Data-mode registry (a copy of asr_finetune_tpu/data/modes.py).

Mode name → train/val source types: `h5`, `parquet`, `parquet_h5`
(parquet train + h5 val), `train_parquet`, `val_parquet`, `val_h5`, and
`folder` (directories of .wav + metadata.csv). The port reads "h5" and
"folder" sources; a mode with a "parquet" source raises when the data is
built (run.build_data): pyarrow is not on the card's machine.
"""
from __future__ import annotations

from typing import Dict

DATA_MODES: Dict[str, Dict[str, str]] = {
    "h5":            {"train": "h5",      "val": "h5"},
    "parquet":       {"train": "parquet", "val": "parquet"},
    "parquet_h5":    {"train": "parquet", "val": "h5"},
    "train_parquet": {"train": "parquet", "val": "h5"},
    "val_parquet":   {"train": "h5",      "val": "parquet"},
    "val_h5":        {"train": "parquet", "val": "h5"},
    "folder":        {"train": "folder",  "val": "folder"},
}


def get_data_mode(name: str) -> Dict[str, str]:
    if name not in DATA_MODES:
        raise ValueError(f"unknown data mode {name!r}; have {sorted(DATA_MODES)}")
    return DATA_MODES[name]

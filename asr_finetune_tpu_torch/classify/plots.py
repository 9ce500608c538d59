"""Error-profile comparison (a copy of asr_finetune_tpu/classify/plots.py).

Merges the error-type CSVs of several models (e.g. before and after
fine-tuning) into one per-type profile, written as JSON and CSV, and as a
bar chart where matplotlib imports (it is imported only here, in the call).
"""
from __future__ import annotations

import csv
import json
import logging
from typing import Dict, Sequence

from .error_types import aggregate_error_profile

logger = logging.getLogger(__name__)


def compare_error_profiles(csv_paths: Sequence[str], labels: Sequence[str],
                           output_prefix: str) -> Dict[str, Dict[str, Dict]]:
    """Merge N error CSVs → {error_type: {label: {mean_p, total_N}}};
    writes <prefix>.json, <prefix>.csv, and <prefix>.png when matplotlib
    is importable."""
    profiles = {lab: aggregate_error_profile(p)
                for lab, p in zip(labels, csv_paths)}
    types = sorted({t for prof in profiles.values() for t in prof})
    merged = {t: {lab: profiles[lab].get(t, {"mean_p": 0.0, "total_N": 0.0})
                  for lab in labels} for t in types}

    with open(output_prefix + ".json", "w") as f:
        json.dump(merged, f, indent=2, ensure_ascii=False)
    with open(output_prefix + ".csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["error_type"] + [f"{lab}_mean_p" for lab in labels]
                   + [f"{lab}_total_N" for lab in labels])
        for t in types:
            w.writerow([t] + [merged[t][lab]["mean_p"] for lab in labels]
                       + [merged[t][lab]["total_N"] for lab in labels])

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        x = np.arange(len(types))
        width = 0.8 / max(len(labels), 1)
        fig, ax = plt.subplots(figsize=(max(8, len(types)), 4.5))
        for i, lab in enumerate(labels):
            ax.bar(x + i * width, [merged[t][lab]["mean_p"] for t in types],
                   width, label=lab)
        ax.set_xticks(x + width * (len(labels) - 1) / 2)
        ax.set_xticklabels(types, rotation=30, ha="right")
        ax.set_ylabel("mean error probability")
        ax.set_title("ASR error-type profile")
        ax.legend()
        fig.tight_layout()
        fig.savefig(output_prefix + ".png", dpi=120)
        plt.close(fig)
    except Exception as e:  # noqa: BLE001 — headless environments
        logger.info("matplotlib unavailable (%s); wrote JSON/CSV only", e)
    return merged

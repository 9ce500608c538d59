"""Centralized machine paths, env-var derived (a copy of
asr_finetune_tpu/paths.py).

Capability parity with the reference's projects_paths.py:22-34 (PROJECT_ROOT,
MODEL_PATH, DATA_PATH, TRAINERS_PATH, RESULTS_PATH built from $USER), minus
the hardcoded usernames. Every path is overridable via environment; both
packages read the same ASR_TPU_* variables.
"""
from __future__ import annotations

import os

PROJECT_ROOT = os.environ.get("ASR_TPU_PROJECT_ROOT", os.getcwd())
MODEL_PATH = os.environ.get("ASR_TPU_MODEL_PATH",
                            os.path.join(PROJECT_ROOT, "models"))
DATA_PATH = os.environ.get("ASR_TPU_DATA_PATH",
                           os.path.join(PROJECT_ROOT, "data"))
RESULTS_PATH = os.environ.get("ASR_TPU_RESULTS_PATH",
                              os.path.join(PROJECT_ROOT, "output"))

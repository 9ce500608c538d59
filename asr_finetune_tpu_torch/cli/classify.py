"""Error-type classification entry point (PyTorch port).

`python -m asr_finetune_tpu_torch.cli.classify --eval_json eval_out/eval_final.json
    --output_csv errors.csv [--llm_model_path <dir> [--device cuda|cpu]
    [--quantize]] [--error_types_csv <csv>] [--save_every N]`

Counterpart of asr_finetune_tpu/cli/classify.py (classify/error_types.py):
scores every transcript of an evaluation against each error type, writes
the CSV (resumable) and prints the per-type profile as JSON. Without
--llm_model_path the rule-based classifier runs and no device is used; with
it the judge runs on the card unless --device cpu. --quantize (CPU dynamic
int8 quantization of the judge) needs --device cpu.
"""
from __future__ import annotations

import argparse
import json

from ..classify.error_types import (DEFAULT_ERROR_TYPES, aggregate_error_profile,
                                    classify_eval_results, load_error_types)
from ..utils.logging_utils import setup_logging


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--eval_json", required=True)
    p.add_argument("--output_csv", required=True)
    p.add_argument("--llm_model_path", default="")
    p.add_argument("--device", default="cuda",
                   help="where the --llm_model_path judge runs: cuda (default) or cpu")
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize the judge's Linear layers (CPU dynamic "
                        "quantization; needs --device cpu)")
    p.add_argument("--error_types_csv", default="")
    p.add_argument("--save_every", type=int, default=20)
    a = p.parse_args(argv)
    setup_logging()

    types = load_error_types(a.error_types_csv) if a.error_types_csv \
        else DEFAULT_ERROR_TYPES
    classify_eval_results(a.eval_json, a.output_csv,
                          model_path=a.llm_model_path or None,
                          error_types=types, save_every=a.save_every,
                          quantize=a.quantize, device=a.device)
    profile = aggregate_error_profile(a.output_csv)
    print(json.dumps(profile, indent=2, ensure_ascii=False))
    return profile


if __name__ == "__main__":
    main()

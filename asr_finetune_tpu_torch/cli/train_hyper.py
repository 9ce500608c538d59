"""HPO experiment entry point (PyTorch port).

`python -m asr_finetune_tpu_torch.cli.train_hyper -c configs/xxx.config
    [flags] [--device cuda|cpu]`

Counterpart of asr_finetune_tpu/cli/train_hyper.py: parses the config, runs
the HPO controller (searcher + ASHA or PBT + trials, hpo/controller.py) on
one card unless --device cpu is given, saves best_result.json and prints
the summary as one JSON line; `--resume_training` restores an unfinished
experiment (completed trials skipped, errored and unfinished ones re-run).

The JAX entry joins a multi-host run when COORDINATOR_ADDRESS (or the
reference's `ip_head`) is set. The port runs in one process: with either
set it raises NotImplementedError instead of carrying on alone.
"""
from __future__ import annotations

import json
import os

from .. import config as config_lib
from ..hpo import controller

MULTI_PROCESS_ENV = ("COORDINATOR_ADDRESS", "ip_head")


def main(argv=None):
    args = config_lib.parse_args(argv)
    if not args.run_on_local_machine:
        named = [k for k in MULTI_PROCESS_ENV if os.environ.get(k)]
        if named:
            raise NotImplementedError(
                f"{', '.join(named)} set: a multi-process experiment is not ported "
                "yet (the port runs one process on one card); unset it or pass "
                "--run_on_local_machine")
    summary = controller.run_experiment(args)
    print(json.dumps(summary, default=str))
    return summary


if __name__ == "__main__":
    main()

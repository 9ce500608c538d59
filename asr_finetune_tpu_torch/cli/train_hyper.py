"""HPO experiment entry point (PyTorch port).

`python -m asr_finetune_tpu_torch.cli.train_hyper -c configs/xxx.config
    [flags] [--device cuda|cpu]`

Counterpart of asr_finetune_tpu/cli/train_hyper.py: parses the config, runs
the HPO controller (searcher + ASHA or PBT + trials, hpo/controller.py) on
one card unless --device cpu is given, saves best_result.json and prints
the summary as one JSON line; `--resume_training` restores an unfinished
experiment (completed trials skipped, errored and unfinished ones re-run).

Data-parallel trials: under torchrun, or with COORDINATOR_ADDRESS (or the
reference's `ip_head`) set under Slurm, every process joins the group
(parallel/mesh.py), runs the controller and takes part in every trial, the
trials one after another over the whole group; rank 0 writes the
experiment's files. --run_on_local_machine stays one process, as in JAX.
"""
from __future__ import annotations

import contextlib
import json
import logging

from .. import config as config_lib
from ..hpo import controller
from ..parallel import mesh
from ..utils.logging_utils import setup_logging


def main(argv=None):
    args = config_lib.parse_args(argv)
    setup_logging(logging.DEBUG if args.debug else logging.INFO)
    with (contextlib.nullcontext() if args.run_on_local_machine
          else mesh.joined(args.device)):
        summary = controller.run_experiment(args)
    print(json.dumps(summary, default=str))
    return summary


if __name__ == "__main__":
    main()

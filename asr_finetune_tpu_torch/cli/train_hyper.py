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
(parallel/mesh.py) and runs the controller; rank 0 writes the experiment's
summary. --run_on_local_machine stays one process, as in JAX.

Trial packing, the reference's fractional gpus_per_trial: one process per
card, and `--chips_per_trial k --max_concurrent_trials m` over the N ranks
of one host runs min(N // k, m) trials at once, each data-parallel over
its slot of k ranks (--tp inside the slot):

    torchrun --nproc_per_node 8 -m asr_finetune_tpu_torch.cli.train_hyper \
        -c <config> --chips_per_trial 2 --max_concurrent_trials 4

Without packing (k 0, or k >= N) every trial spans every rank, one trial
after another, and so it does over more than one host. One process with
several cards and a plan of more than one slot raises, naming the torchrun
launch. On the CPU, ranks of the gloo group pack alike (--device cpu, RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and COORDINATOR_ADDRESS per
process).
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

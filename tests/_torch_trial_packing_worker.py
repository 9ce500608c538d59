"""One process of tests/test_torch_trial_packing.py: `cli.train_hyper` on
the CPU, as a rank of a gloo group (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE and COORDINATOR_ADDRESS set) or, without them, as the
one-process serial reference.

    python tests/_torch_trial_packing_worker.py <spec.json> <out.json>

The spec names cli.train_hyper's argv, the trials to fail on every rank
(`fail`: the worker raises in place of the trial, the package is
unchanged) and whether to run the experiment again with
--resume_training. Writes <out.json>: the summary, every trial this
process ran (its slot, rank in the trial group, group size and wall
interval), the trials the resume ran and the resumed summary. The run and
its resume share one group. `claim_all` is the test's claiming process
under the lock. Imports no JAX.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
# TensorBoard's writer imports TensorFlow where it is installed (~15 s a
# process on the CPU); without it the writer takes its own stub
sys.modules.setdefault("tensorflow", None)

import torch  # noqa: E402

from asr_finetune_tpu_torch import config as TC  # noqa: E402
from asr_finetune_tpu_torch import run as run_lib  # noqa: E402
from asr_finetune_tpu_torch.cli import train_hyper  # noqa: E402
from asr_finetune_tpu_torch.hpo import controller as TCTL  # noqa: E402
from asr_finetune_tpu_torch.hpo.space import get_whisper_hyperparameters  # noqa: E402
from asr_finetune_tpu_torch.parallel import mesh  # noqa: E402


def claim_all(argv, exp_dir: str):
    """Claim trials of the experiment in `exp_dir` (its files made by the
    controller's start) until its queue is empty, as a slot's leader does:
    [index, hp] of each claim."""
    args = TC.parse_args(argv)
    files = TCTL._Files(exp_dir, shared=True)
    space = get_whisper_hyperparameters(args)
    got = []
    while (claim := TCTL._claim(args, files, space, "min")) is not None:
        got.append([claim[0], claim[1]])
    return got


def main(spec_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    ran = []
    orig = run_lib.run_trial

    def run_trial(args, hp=None, trial_dir=None, **kw):
        trial = os.path.basename(trial_dir)
        rec = {"trial": trial, "hp": hp, "slot": mesh.trial_slot(), "rank": mesh.rank(),
               "world": mesh.world(), "global_rank": mesh.global_rank(),
               "start": time.time()}
        ran.append(rec)
        try:
            if trial in spec.get("fail", ()):
                raise RuntimeError(f"injected fault in {trial}")
            return orig(args, hp, trial_dir, **kw)
        finally:
            rec["end"] = time.time()

    run_lib.run_trial = run_trial
    with mesh.joined("cpu"):         # one group for the run and its resume
        out = {"summary": train_hyper.main(spec["argv"]), "ran": ran}
        if spec.get("resume"):
            n = len(ran)
            out["resumed"] = train_hyper.main(spec["argv"] + ["--resume_training"])
            out["resume_ran"] = ran[n:]
            del ran[n:]
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

"""One rank of tests/test_torch_parallel.py's two-process gloo group.

    COORDINATOR_ADDRESS=127.0.0.1:<port> RANK=<r> WORLD_SIZE=2 \
        python tests/_torch_dp_worker.py <work dir>

Joins the group from the JAX names (parallel/mesh.py), then, on this rank's
rows of the test's global batches (<work>/inputs.npz, <work>/spec.json):
full fine-tuning steps (SpecAugment off and on) and PEFT AdaLoRA steps
(lora dropout off and on); a
two-trial `cli.train_hyper`; and `cli.train --resume_training` from a
one-process checkpoint, checking that each rank restored its slice of the
saved moments. Writes <work>/rank<r>.json and rank<r>.npz. Imports no JAX:
`run_steps` is also the test's one-process reference.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from asr_finetune_tpu_torch.models import native_io as TIO  # noqa: E402
from asr_finetune_tpu_torch.models.configs import WhisperConfig  # noqa: E402
from asr_finetune_tpu_torch.parallel import mesh  # noqa: E402
from asr_finetune_tpu_torch.training import lora as TL  # noqa: E402
from asr_finetune_tpu_torch.training import optim as TO  # noqa: E402
from asr_finetune_tpu_torch.training import train_step as TTS  # noqa: E402

LR = 1e-4
MAX_STEPS = 4
OPT_KW = dict(scheduler="linear", warmup_steps=1, weight_decay=0.01, max_grad_norm=1.0)


def tree(arrays, prefix: str):
    """The tree stored under `prefix/` in the npz as port tensors."""
    flat = {k[len(prefix) + 1:]: arrays[k] for k in arrays.files if k.startswith(prefix + "/")}
    return TIO.params_from_numpy(flat, "cpu")


def run_steps(arrays, small: dict, kind: str, n_steps: int, rows=None):
    """`n_steps` train steps of `kind` ("full", "full_spec_augment", "peft"
    or "peft_dropout")
    on the global batches batch<i> of the npz, or on their rows [lo, hi)
    (`rows`: this rank's in a group). Returns (metrics per step, the
    trained trees as numpy, the optimizer moments' shapes)."""
    cfg = WhisperConfig(**small)
    peft = kind.startswith("peft")
    if peft:
        lcfg = TL.LoraConfig(rank=4, alpha=8.0, dropout=0.1 if kind == "peft_dropout" else 0.0,
                             adalora=True, delta_t=1)
        adapters = tree(arrays, "adapters")
        opt = TO.make_optimizer(LR, MAX_STEPS, trainable_mask=TO.adapter_freeze_mask(
            adapters, True), **OPT_KW)
        state = TTS.make_train_state(tree(arrays, "base"), opt, adapters, adalora=True)
        step_cfg = TTS.TrainStepConfig(mode="peft", compute_dtype=torch.float32, remat=True,
                                       lora=lcfg, max_steps=MAX_STEPS, seed=5)
    else:
        opt = TO.make_optimizer(LR, 10, **OPT_KW)
        state = TTS.make_train_state(tree(arrays, "full"), opt)
        step_cfg = TTS.TrainStepConfig(compute_dtype=torch.float32, remat=False,
                                       spec_augment=kind == "full_spec_augment", seed=5)
    step = TTS.make_train_step(cfg, opt, step_cfg)
    metrics = []
    for i in range(n_steps):
        batch = {k: torch.from_numpy(arrays[f"batch{i}/{k}"])
                 for k in ("mel", "decoder_input_ids", "labels")}
        if rows is not None:
            batch = {k: v[rows[0]: rows[1]] for k, v in batch.items()}
        m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    trees = {t: TIO.params_to_numpy(state[t])
             for t in (("adapters", "rank_mask", "sensitivity") if peft else ("params",))}
    shapes = [list(m.shape) for m in state["opt_state"]["mu"]]
    return metrics, trees, shapes


def _restore_check(out: dict):
    """Wrap CheckpointManager.restore: after it, each moment must equal this
    rank's slice of the whole moment saved."""
    from asr_finetune_tpu_torch.training import checkpoint as ckpt_lib
    orig = ckpt_lib.CheckpointManager.restore

    def restore(self, state_like, step=None):
        got = orig(self, state_like, step)
        _, saved = self._load(step, "cpu")
        opt = got["opt_state"]
        out["restored_step"] = int(got["step"])
        out["restored_slices_equal"] = all(
            torch.equal(m, s.of(saved["mu"][k])) and torch.equal(v, s.of(saved["nu"][k]))
            for k, s, m, v in zip(opt["names"], opt["shards"], opt["mu"], opt["nu"]))
        out["restored_split"] = sum(s.axis is not None for s in opt["shards"])
        return got
    ckpt_lib.CheckpointManager.restore = restore


def main(work: str) -> None:
    torch.set_num_threads(2)
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    dev = mesh.initialize("cpu")
    r, w = mesh.rank(), mesh.world()
    out = {"rank": r, "world": w, "device": str(dev),
           "backend": torch.distributed.get_backend()}
    arrays = np.load(os.path.join(work, "inputs.npz"))
    B = arrays["batch0/labels"].shape[0]
    rows = (r * B // w, (r + 1) * B // w)
    saved = {}
    for kind in ("full", "full_spec_augment", "peft", "peft_dropout"):
        metrics, trees, shapes = run_steps(arrays, spec["small"], kind, spec["n_steps"], rows)
        out[kind] = {"metrics": metrics, "moment_shapes": shapes}
        for t, flat in trees.items():
            saved.update({f"{kind}/{t}/{k}": v for k, v in flat.items()})
    np.savez(os.path.join(work, f"rank{r}.npz"), **saved)

    from asr_finetune_tpu_torch.cli import train as train_cli
    from asr_finetune_tpu_torch.cli import train_hyper
    out["hyper"] = json.loads(json.dumps(train_hyper.main(spec["hyper_argv"]), default=str))
    _restore_check(out)
    out["resume"] = train_cli.main(spec["resume_argv"])
    with open(os.path.join(work, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    mesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])

"""One rank of tests/test_torch_tp.py's gloo groups (tensor parallelism).

    COORDINATOR_ADDRESS=127.0.0.1:<port> RANK=<r> WORLD_SIZE=<n> \
        python tests/_torch_tp_worker.py <work dir> <group>

Group "tp2" (two ranks, --tp 2): full fine-tuning steps, the plain W8A8
product split by input rows, greedy decodes (float, and PEFT over the int8
base with W8A8), the layouts and decodes that must raise, and cli.train
--tp 2: full fine-tuning resident and with --offload_optimizer, resumed
from a one-process checkpoint, and PEFT AdaLoRA with --int8_matmul; and a
two-trial cli.train_hyper experiment at --tp 2.
Group "dp2tp2" (four ranks, data 2 x model 2): full fine-tuning steps and
PEFT AdaLoRA steps over the int8 base with W8A8, with calibrated outliers
and in the dynamic top-k form.

Inputs: <work>/inputs.npz and <work>/spec.json; writes
<work>/<group>_rank<r>.json and .npz. Imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from asr_finetune_tpu_torch import run as run_lib  # noqa: E402
from asr_finetune_tpu_torch.evaluation import decode as TD  # noqa: E402
from asr_finetune_tpu_torch.models import native_io as TIO  # noqa: E402
from asr_finetune_tpu_torch.models.configs import WhisperConfig  # noqa: E402
from asr_finetune_tpu_torch.ops import quant as TQ  # noqa: E402
from asr_finetune_tpu_torch.parallel import mesh  # noqa: E402
from asr_finetune_tpu_torch.parallel import sharding as SH  # noqa: E402
from asr_finetune_tpu_torch.training import lora as TL  # noqa: E402
from asr_finetune_tpu_torch.training import optim as TO  # noqa: E402
from asr_finetune_tpu_torch.training import train_step as TTS  # noqa: E402

LR = 1e-3
MAX_STEPS = 4
OPT_KW = dict(scheduler="linear", warmup_steps=1, weight_decay=0.01, max_grad_norm=1.0)
OUTLIER_COLS = 2
CALIB_THRESHOLD = 2.0       # random weights: activations far below bitsandbytes' 6.0


def tree(arrays, prefix: str):
    """The tree stored under `prefix/` in the npz as port tensors."""
    flat = {k[len(prefix) + 1:]: arrays[k] for k in arrays.files if k.startswith(prefix + "/")}
    return TIO.params_from_numpy(flat, "cpu")


def batch(arrays, i: int, rows=None):
    b = {k: torch.from_numpy(arrays[f"batch{i}/{k}"])
         for k in ("mel", "decoder_input_ids", "labels")}
    return b if rows is None else {k: v[rows[0]: rows[1]] for k, v in b.items()}


def peft_setup(arrays, cfg, calibrate: bool = True):
    """The PEFT state over this rank's slice of the int8 base, its step
    config (W8A8 with 2 outlier columns) and the calibrated sets: every rank
    calibrates on the same 4 rows of batch 0, as run.calibrate_outliers;
    without `calibrate` every product takes the dynamic top-k form."""
    lcfg = TL.LoraConfig(rank=4, alpha=8.0, dropout=0.0, adalora=True, delta_t=1)
    adapters = tree(arrays, "adapters")
    base = SH.split_tree(tree(arrays, "base"), mesh.model_rank(), mesh.model_world())
    opt = TO.make_optimizer(LR, MAX_STEPS, trainable_mask=TO.adapter_freeze_mask(
        adapters, True), **OPT_KW)
    state = TTS.make_train_state(base, opt, adapters, adalora=True)
    quant = TQ.QuantConfig(matmul=True, outlier_cols=OUTLIER_COLS)
    step_cfg = TTS.TrainStepConfig(mode="peft", compute_dtype=torch.float32, remat=True,
                                   lora=lcfg, max_steps=MAX_STEPS, seed=5, quant=quant)
    if not calibrate:
        return state, opt, step_cfg, None
    estep = TTS.make_eval_loss_step(cfg, dataclasses.replace(step_cfg, remat=False))
    idx = TQ.calibrate_int8_outliers(
        lambda: estep({"params": base, "adapters": adapters}, batch(arrays, 0, (0, 4))),
        quant, threshold=CALIB_THRESHOLD, max_cols=2 * OUTLIER_COLS)
    return state, opt, step_cfg, idx


def run_steps(arrays, small: dict, kind: str, n_steps: int):
    """`n_steps` train steps of `kind` ("full", "peft" or "peft_dynamic":
    no calibration) on this data rank's rows of the global batches.
    Returns (metrics per step, the trained trees whole as numpy, the
    calibrated sets or None)."""
    cfg = WhisperConfig(**small)
    idx = None
    peft = kind.startswith("peft")
    if peft:
        state, opt, step_cfg, idx = peft_setup(arrays, cfg, kind == "peft")
    else:
        opt = TO.make_optimizer(LR, 10, **OPT_KW)
        params = SH.split_tree(tree(arrays, "full"), mesh.model_rank(), mesh.model_world())
        state = TTS.make_train_state(params, opt)
        step_cfg = TTS.TrainStepConfig(compute_dtype=torch.float32, remat=True, seed=5)
    step = TTS.make_train_step(cfg, opt, step_cfg)
    B, dw = arrays["batch0/labels"].shape[0], mesh.data_world()
    rows = (mesh.data_rank() * B // dw, (mesh.data_rank() + 1) * B // dw)
    metrics = [{k: float(v) for k, v in step(state, batch(arrays, i, rows)).items()}
               for i in range(n_steps)]
    if peft:
        trees = {t: TIO.params_to_numpy(state[t])
                 for t in ("adapters", "rank_mask", "sensitivity")}
    else:
        trees = {"params": TIO.params_to_numpy(SH.gather_tree(state["params"]))}
    return metrics, trees, idx


def split_w8a8(arrays) -> dict:
    """The row-split W8A8 product: this rank's K / tp columns of x against
    its rows of the int8 weight, with the whole rows' amax (and with the
    slice's own amax, which must differ), summed over the ranks; calibrated
    sets of the whole K and the dynamic top-k form."""
    x, w8, ws = (torch.from_numpy(arrays[f"w8a8/{k}"]) for k in ("x", "w_q8", "w_scale"))
    K, tp, r = x.shape[1], mesh.model_world(), mesh.model_rank()
    n = K // tp
    xl, wl = x[:, r * n:(r + 1) * n].contiguous(), w8[r * n:(r + 1) * n].contiguous()
    static = tuple(int(i) for i in arrays["w8a8/static"])
    out = {}
    forms = {"plain": TQ.QuantConfig(matmul=True),
             "static": TQ.QuantConfig(matmul=True, outlier_cols=OUTLIER_COLS,
                                      static_idx={(K, w8.shape[1]): static}),
             "dynamic": TQ.QuantConfig(matmul=True, outlier_cols=OUTLIER_COLS)}
    for name, q in forms.items():
        y = TQ.int8_matmul(xl, wl, ws, q, row_split=True)
        out[name] = mesh.all_reduce_sum_(y.clone(), over="model").numpy()
    # the slice's own row scale: what the whole-row amax prevents
    own = TQ.Int8Matmul.apply(xl, wl, ws, forms["plain"], None, False)
    out["own_scale"] = mesh.all_reduce_sum_(own.clone(), over="model").numpy()
    return out


def greedy(arrays, small: dict) -> dict:
    """fp32 greedy decodes over this rank's slice: the float model, and the
    int8 base with W8A8 in its dynamic top-k form and unmerged adapters."""
    cfg = WhisperConfig(**small)
    mel = torch.from_numpy(arrays["decode/mel"])
    forced = [int(t) for t in arrays["decode/forced"]]
    out = {}
    params = SH.split_tree(tree(arrays, "full"), mesh.model_rank(), mesh.model_world())
    out["float"], _ = TD.greedy_decode(params, mel, cfg, forced, 12, torch.float32)
    base = SH.split_tree(tree(arrays, "base"), mesh.model_rank(), mesh.model_world())
    quant = TQ.QuantConfig(matmul=True, outlier_cols=OUTLIER_COLS)
    out["peft_int8"], _ = TD.greedy_decode(base, mel, cfg, forced, 12, torch.float32,
                                           adapters=tree(arrays, "adapters"), quant=quant)
    return {k: v.tolist() for k, v in out.items()}


def must_raise(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def refusals(small: dict) -> dict:
    """What must raise: --tp 3 over two ranks, a fused decode under tp 2."""
    cfg = WhisperConfig(**small)
    out = {"tp3": must_raise(lambda: run_lib.check_parallel_layout(
        argparse.Namespace(tp=3)))}
    run_lib.check_parallel_layout(argparse.Namespace(tp=2))
    out["fused_true"] = must_raise(lambda: TD._resolve_fused(True, cfg, torch.device("cpu")))
    os.environ["ASR_TPU_FUSED_DECODE"] = "1"
    try:
        out["fused_env"] = must_raise(lambda: TD._resolve_fused(None, cfg,
                                                               torch.device("cpu")))
    finally:
        del os.environ["ASR_TPU_FUSED_DECODE"]
    out["fused_default"] = TD._resolve_fused(None, cfg, torch.device("cpu"))
    return out


def restore_check(out: dict):
    """Wrap CheckpointManager.restore: after it, each parameter and moment
    must equal this rank's slice of the whole one saved."""
    from asr_finetune_tpu_torch.training import checkpoint as ckpt_lib
    orig = ckpt_lib.CheckpointManager.restore

    def restore(self, state_like, step=None):
        got = orig(self, state_like, step)
        _, saved = self._load(step, "cpu")
        r, tp = mesh.model_rank(), mesh.model_world()
        opt = got["opt_state"]
        params = dict(TO.leaves(got["params"]))
        out["restored_step"] = int(got["step"])
        out["restored_params_equal"] = all(
            torch.equal(p, SH.local_slice(k, saved["params"][k], r, tp))
            for k, p in params.items())
        out["restored_moments_equal"] = all(
            torch.equal(m, s.of(SH.local_slice(k, saved["mu"][k], r, tp)))
            for k, s, m in zip(opt["names"], opt["shards"], opt["mu"]))
        out["restored_split"] = sum(opt["tp_split"])
        return got
    ckpt_lib.CheckpointManager.restore = restore


def main(work: str, group: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    mesh.initialize("cpu")
    out = {"rank": mesh.rank(), "world": mesh.world()}
    arrays = np.load(os.path.join(work, "inputs.npz"))
    small = spec["small"]
    if group == "tp2":
        out["refusals"] = refusals(small)
    mesh.set_tensor_parallel(spec["groups"][group]["tp"])
    out.update(data_rank=mesh.data_rank(), model_rank=mesh.model_rank())
    saved = {}
    for kind in spec["groups"][group]["kinds"]:
        metrics, trees, idx = run_steps(arrays, small, kind, spec["n_steps"])
        out[kind] = {"metrics": metrics,
                     "calibrated": None if idx is None else {
                         f"{k[0]}x{k[1]}": list(v) for k, v in idx.items()}}
        for t, flat in trees.items():
            saved.update({f"{kind}/{t}/{k}": v for k, v in flat.items()})
    if group == "tp2":
        saved.update({f"w8a8/{k}": v for k, v in split_w8a8(arrays).items()})
        out["greedy"] = greedy(arrays, small)
        from asr_finetune_tpu_torch.cli import train as train_cli
        from asr_finetune_tpu_torch.cli import train_hyper
        out["cli"] = {name: train_cli.main(argv) for name, argv in spec["cli"].items()}
        out["hyper"] = json.loads(json.dumps(train_hyper.main(spec["hyper_argv"]),
                                             default=str))
        restore_check(out)
        out["resume"] = train_cli.main(spec["resume_argv"])
    np.savez(os.path.join(work, f"{group}_rank{mesh.rank()}.npz"), **saved)
    with open(os.path.join(work, f"{group}_rank{mesh.rank()}.json"), "w") as f:
        json.dump(out, f, default=str)
    mesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

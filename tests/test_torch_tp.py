"""Tensor parallelism in the port (--tp: parallel/mesh.set_tensor_parallel,
parallel/sharding.split_tree / gather_tree, the split model, the
row-split W8A8 product, the train step, checkpoints, the eval decode and
cli.train), on the CPU with gloo, against the JAX package's "model" axis
(`param_shardings` on create_mesh) and against one process.

One module fixture starts two process groups at once, each process with a
timeout of its own (tests/_torch_tp_worker.py): "tp2", two ranks at --tp
2, and "dp2tp2", four ranks at data 2 x model 2. Meanwhile the test
process computes the JAX and one-process references."""
import csv
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import WhisperConfig as JConfig
from asr_finetune_tpu.models.configs import get_config as jax_config
from asr_finetune_tpu.ops import quant as JQ
from asr_finetune_tpu.parallel import mesh as JM
from asr_finetune_tpu.parallel import sharding as JS
from asr_finetune_tpu.training import lora as JL
from asr_finetune_tpu.training import optim as JO
from asr_finetune_tpu.training import train_step as JTS
from asr_finetune_tpu_torch import config as config_lib
from asr_finetune_tpu_torch import run as run_lib
from asr_finetune_tpu_torch.cli import train as train_cli
from asr_finetune_tpu_torch.evaluation import decode as TD
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig
from asr_finetune_tpu_torch.ops import quant as TQ
from asr_finetune_tpu_torch.parallel import sharding
from asr_finetune_tpu_torch.training.optim import leaves

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "_torch_tp_worker.py"
# 64-dim heads (2 heads: one a rank at tp 2); 150 encoder frames
SMALL = dict(vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
             encoder_heads=2, decoder_layers=2, decoder_heads=2, d_ff=256,
             max_source_positions=150, max_target_positions=32,
             eos_token_id=290, sot_token_id=291, translate_token_id=293,
             transcribe_token_id=294, no_timestamps_token_id=295,
             timestamp_begin_id=296, pad_token_id=290, first_language_token_id=292)
N_STEPS = 2
PROC_TIMEOUT = 240
GROUPS = {"tp2": {"world": 2, "tp": 2, "kinds": ["full"]},
          "dp2tp2": {"world": 4, "tp": 2, "kinds": ["full", "peft", "peft_dynamic"]}}
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT", "COORDINATOR_ADDRESS", "ip_head", "SLURM_PROCID", "SLURM_NTASKS",
            "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE")


def _load_worker():
    import importlib.util
    spec = importlib.util.spec_from_file_location("_torch_tp_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), **extra)
    return env


def _batches(n: int, B: int = 4, T: int = 12):
    """Global batches whose rows hold different label counts."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(20 + i)
        toks = rng.integers(0, 289, (B, T)).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], np.full((B, 1), 290, np.int32)], axis=1)
        labels[0, -5:] = -100
        labels[3, -2:] = -100
        out.append({"mel": rng.standard_normal((B, 300, 16)).astype(np.float32),
                    "decoder_input_ids": toks, "labels": labels})
    return out


def _write_folder(d: pathlib.Path, n: int = 6) -> str:
    d.mkdir()
    rng = np.random.default_rng(0)
    texts = ["Wir sind nach Hause gegangen.", "Die Schule war klein.",
             "Mein Vater hat erzählt.", "Das Dorf lag am Fluss."]
    with open(d / "metadata.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "transcription"])
        for i in range(n):
            sig = rng.standard_normal(int(16000 * rng.uniform(0.5, 1.0))) * 0.1
            with wave.open(str(d / f"u{i}.wav"), "wb") as wf:
                wf.setnchannels(1)
                wf.setsampwidth(2)
                wf.setframerate(16000)
                wf.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())
            w.writerow([f"u{i}.wav", texts[i % len(texts)]])
    return str(d)


def _nano(folder, out, *extra):
    """test-nano (2 heads of 32) full fine-tuning in fp32, 4 train / 2
    validation utterances, batch 2, eval batch 2, eval + save every 2
    steps."""
    return ["--model_type", "test-nano", "--device", "cpu", "--no-bf16", "--data_mode", "folder",
            "--dataset_name", folder, "--val_split", "0.34",
            "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "2",
            "--max_steps", "2", "--eval_steps", "2", "--save_steps", "2",
            "--logging_steps", "1", "--learning_rate", "1e-3",
            "--lr_scheduler_type", "constant", "--generation_max_length", "8",
            "--wer_weight", "0.7", "--num_to_keep", "3", "--output_dir", str(out),
            "--output_tag", "run", "--random_seed", "3", *extra]


PEFT = ("--peft", "--load_in_8bit", "--adalora", "--lora_rank", "4", "--lora_alpha", "8",
        "--int8_matmul", "--int8_outlier_threshold", "0.5")


def _communicate(procs, what):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=PROC_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{what} exited {p.returncode}:\n{out[-6000:]}"
    return outs


def _jax_inputs():
    """The JAX parameters for full fine-tuning (every bias moved off zero,
    so a bias added on each rank before the sum would show), the int8 base
    of the JAX init (zero biases: larger activations flip more int8
    roundings of W8A8 between any two orders of fp32 sums, one process
    against JAX as much as tp 2 against one process, ~5e-5 of the loss) and
    adapters (b moved off zero so every term of the delta is live)."""
    jcfg = JConfig(**SMALL)
    init = JW.init_params(jax.random.PRNGKey(3), jcfg)
    p_rng = np.random.default_rng(8)
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, a: a + jnp.asarray(0.1 * p_rng.standard_normal(a.shape), jnp.float32)
        if p[-1].key == "b" else a, init)
    jbase = JQ.quantize_tree_int8(init)
    lcfg = JL.LoraConfig(rank=4, alpha=8.0, dropout=0.0, adalora=True, delta_t=1)
    jad = JL.init_adapters(jax.random.PRNGKey(4), jcfg, lcfg, encoder=True)
    b_rng = np.random.default_rng(9)
    jad = jax.tree_util.tree_map_with_path(
        lambda p, a: a + jnp.asarray(0.02 * b_rng.standard_normal(a.shape), jnp.float32)
        if p[-1].key == "b" else a, jad)
    return jcfg, jparams, jbase, jad, lcfg


def _w8a8_inputs():
    """x (6, 128) with two loud columns, one in each rank's half; an int8
    weight (128, 64) and its scales; a calibrated set across both halves."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 128)).astype(np.float32)
    x[:, 17] *= 40.0
    x[:, 90] *= 25.0
    w = rng.standard_normal((128, 64)).astype(np.float32)
    q = JQ.quantize_weight(jnp.asarray(w))
    return {"w8a8/x": x, "w8a8/w_q8": np.asarray(q["w_q8"]),
            "w8a8/w_scale": np.asarray(q["w_scale"]).reshape(-1),
            "w8a8/static": np.asarray([17, 40, 90], np.int64)}


def _jax_steps(jcfg, params, make_state, tx, step_cfg, batches, data=1, model=1):
    """JAX's make_train_step on create_mesh(data, model), the parameters
    placed by `param_shardings` and the batch split over "data" (the rest
    replicated, as JAX run.py places them); on one device at 1 x 1.
    make_state(params) builds the train state."""
    step = jax.jit(JTS.make_train_step(jcfg, tx, step_cfg))
    put = jnp.asarray
    if data * model > 1:
        m = JM.create_mesh(data=data, model=model, devices=jax.devices()[:data * model])
        params = JS.shard_tree(params, JS.param_shardings(params, m))
        put = lambda v: jax.device_put(jnp.asarray(v), JM.batch_sharding(m))  # noqa: E731
    state = make_state(params)
    metrics = []
    for b in batches:
        state, mt = step(state, {k: put(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in mt.items()})
    return state, metrics


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    root = tmp_path_factory.mktemp("tp")
    jcfg, jparams, jbase, jad, lcfg = _jax_inputs()
    batches = _batches(N_STEPS)
    rng = np.random.default_rng(11)
    arrays = {**{f"full/{k}": np.asarray(v) for k, v in JIO._flatten(jparams).items()},
              **{f"base/{k}": np.asarray(v) for k, v in JIO._flatten(jbase).items()},
              **{f"adapters/{k}": np.asarray(v) for k, v in JIO._flatten(jad).items()},
              **{f"batch{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()},
              **_w8a8_inputs(),
              "decode/mel": rng.standard_normal((2, 300, 16)).astype(np.float32),
              "decode/forced": np.asarray([291, 292, 294, 295], np.int64)}
    np.savez(root / "inputs.npz", **arrays)
    folder = _write_folder(root / "folder")

    # a one-process checkpoint for the two ranks to resume
    one = root / "one"
    train_cli.main(_nano(folder, one))
    shutil.copytree(one, root / "one_to_two")
    spec = {"small": SMALL, "n_steps": N_STEPS, "groups": GROUPS,
            "cli": {"two": _nano(folder, root / "two", "--tp", "2"),
                    "two_offload": _nano(folder, root / "two_offload", "--tp", "2",
                                         "--offload_optimizer"),
                    "two_peft": _nano(folder, root / "two_peft", "--tp", "2", *PEFT)},
            "resume_argv": _nano(folder, root / "one_to_two", "--tp", "2",
                                 "--resume_training", "--max_steps", "4"),
            "hyper_argv": _nano(folder, root / "out", "--tp", "2", *PEFT,
                                "--storage_path", str(root / "hpo"), "--num_samples", "2",
                                "--hyperparameters", "learning_rate,rank",
                                "--grace_period", "2", "--output_tag", "exp")}
    (root / "spec.json").write_text(json.dumps(spec))

    procs = {}
    for group, g in GROUPS.items():
        port = _free_port()
        procs[group] = [subprocess.Popen(
            [sys.executable, str(WORKER), str(root), group], cwd=REPO, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=_env(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", RANK=str(r),
                     WORLD_SIZE=str(g["world"])))
            for r in range(g["world"])]

    out = {"root": root, "folder": folder, "arrays": arrays}
    worker = _load_worker()
    try:
        # the references, while the ranks run
        kw = dict(scheduler="linear", warmup_steps=1, weight_decay=0.01, max_grad_norm=1.0)
        full_cfg = JTS.TrainStepConfig(mode="full", compute_dtype=jnp.float32, remat=False)
        tx = JO.make_optimizer(worker.LR, 10, **kw)
        for data, model in ((1, 1), (1, 2)):
            out[f"jax_full_{data}x{model}"] = _jax_steps(
                jcfg, jparams, lambda p: JTS.make_train_state(p, tx), tx, full_cfg, batches,
                data, model)
        ptx = JO.make_optimizer(worker.LR, worker.MAX_STEPS,
                                trainable_mask=JO.adapter_freeze_mask(jad, True), **kw)
        pcfg = JTS.TrainStepConfig(mode="peft", compute_dtype=jnp.float32, remat=False,
                                   lora=lcfg, max_steps=worker.MAX_STEPS)
        JQ.set_int8_compute(True)
        JQ.set_int8_outlier_cols(worker.OUTLIER_COLS)
        try:
            estep = jax.jit(JTS.make_eval_loss_step(jcfg, pcfg))
            calib = {k: jnp.asarray(v[:4]) for k, v in batches[0].items()}
            out["jax_calibrated"] = JQ.calibrate_int8_outliers(
                lambda: jax.block_until_ready(estep({"params": jbase, "adapters": jad},
                                                    calib)),
                threshold=worker.CALIB_THRESHOLD, max_cols=2 * worker.OUTLIER_COLS)
            out["jax_peft_2x2"] = _jax_steps(
                jcfg, jbase, lambda p: JTS.make_train_state(p, ptx, adapters=jad,
                                                            adalora=True),
                ptx, pcfg, batches, 2, 2)
        finally:
            JQ.set_int8_compute(False)
            JQ.set_int8_outlier_cols(0)
            JQ.set_int8_outlier_static_idx(None)
        # the one-process port: the W8A8 product whole, the greedy decodes
        npz = np.load(root / "inputs.npz")
        x, w8, ws = (torch.from_numpy(npz[f"w8a8/{k}"]) for k in ("x", "w_q8", "w_scale"))
        static = {(128, 64): tuple(int(i) for i in npz["w8a8/static"])}
        out["w8a8_whole"] = {
            name: TQ.int8_matmul(x, w8, ws, q).numpy() for name, q in (
                ("plain", TQ.QuantConfig(matmul=True)),
                ("static", TQ.QuantConfig(matmul=True, outlier_cols=2, static_idx=static)),
                ("dynamic", TQ.QuantConfig(matmul=True, outlier_cols=2)))}
        out["greedy_one"] = worker.greedy(npz, SMALL)
        out["one_process_peft"] = worker.run_steps(npz, SMALL, "peft", N_STEPS)
        out["one_process_peft_dynamic"] = worker.run_steps(npz, SMALL, "peft_dynamic",
                                                           N_STEPS)
    finally:
        logs = {g: _communicate(p, f"{g} worker") for g, p in procs.items()}
    out["logs"] = logs
    for group, g in GROUPS.items():
        out[group] = [json.loads((root / f"{group}_rank{r}.json").read_text())
                      for r in range(g["world"])]
        out[group + "_arrays"] = [dict(np.load(root / f"{group}_rank{r}.npz"))
                                  for r in range(g["world"])]

    # the two ranks' step-2 shard evaluated by one process
    shutil.copytree(root / "two", root / "two_eval")
    trainer = run_lib.setup_trial(config_lib.parse_args(_nano(folder, root / "two_eval")))
    try:
        trainer.state = trainer.checkpoints.restore(trainer.state, 2)
        out["one_process_eval"] = trainer.evaluate(2)
    finally:
        trainer.metrics.close()
    # the two ranks' checkpoint resumed by one process; the one-process
    # checkpoint resumed by one process (what one_to_two did on two ranks)
    shutil.copytree(root / "two", root / "two_to_one")
    out["two_to_one"] = train_cli.main(_nano(folder, root / "two_to_one",
                                             "--resume_training", "--max_steps", "4"))
    shutil.copytree(one, root / "one_to_one")
    out["one_to_one"] = train_cli.main(_nano(folder, root / "one_to_one",
                                             "--resume_training", "--max_steps", "4"))
    torch.set_num_threads(n)
    return out


def _close(ours, ref, what, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol, err_msg=what)


def _saved(root, run, step):
    return torch.load(root / run / "run" / "checkpoints" / f"step_{step:08d}" / "state.pt",
                      weights_only=True)


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("form", ["float", "int8"])
def test_tp_axis_is_param_shardings_model_entry(form):
    """The port's tp_axis is the "model" entry of JAX param_shardings on
    create_mesh(data=4, model=2) for every leaf of test-nano (float and
    quantize_tree_int8); gather_tree(split_tree(t)) is t on one rank."""
    m = JM.create_mesh(data=4, model=2)
    jparams = JW.init_params(jax.random.PRNGKey(0), jax_config("test-nano"))
    if form == "int8":
        jparams = JQ.quantize_tree_int8(jparams)
    specs = JS.param_shardings(jparams, m)
    split = 0
    for (path, s), leaf in zip(jax.tree_util.tree_leaves_with_path(specs),
                               jax.tree.leaves(jparams)):
        name = "/".join(p.key for p in path)
        axes = [i for i, a in enumerate(s.spec) if a == JM.MODEL_AXIS]
        ours = sharding.tp_axis(name, leaf.shape, 2)
        assert ours == (axes[0] if axes else None), name
        split += ours is not None
    assert split > 0
    t = TIO.params_from_numpy({k: np.asarray(v) for k, v in JIO._flatten(jparams).items()},
                              "cpu")
    parts = [sharding.split_tree(t, r, 2) for r in range(2)]
    for k, v in leaves(t):
        axis = sharding.tp_axis(k, v.shape, 2)
        halves = [dict(leaves(p))[k] for p in parts]
        if axis is None:
            assert all(h is v for h in halves), k
        else:
            assert torch.equal(torch.cat(halves, dim=axis), v), k


def test_tp_axis_keeps_an_indivisible_leaf_whole_and_the_layout_checks():
    """ok(): a dimension that does not divide by tp stays whole, as in JAX;
    the port raises where heads or d_ff do not divide (each rank runs whole
    heads); --tp 2 in one process raises, as JAX create_mesh does."""
    assert sharding.tp_axis("encoder/layers/attn/q/w", (2, 64, 64), 3) is None
    assert sharding.tp_axis("encoder/layers/attn/q/w", (2, 64, 64), 2) == 2
    assert sharding.tp_axis("encoder/layers/attn/o/w", (2, 64, 64), 2) == 1
    assert sharding.tp_axis("encoder/layers/attn/o/b", (2, 64), 2) is None
    assert sharding.tp_axis("encoder/layers/attn/q/w_q8_nk", (2, 64, 64), 2) == 1
    assert sharding.tp_axis("encoder/layers/mlp/fc2/w_q8_nk", (2, 64, 256), 2) == 2
    with pytest.raises(ValueError, match="do not divide"):
        sharding.check_tensor_parallel(TConfig(**SMALL), 4)
    sharding.check_tensor_parallel(TConfig(**SMALL), 2)
    with pytest.raises(ValueError, match="tensor-parallel groups of 2"):
        train_cli.main(["--model_type", "test-nano", "--device", "cpu", "--tp", "2",
                        "--dataset_name", "unused", "--output_dir", "/nonexistent"])


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("group,jax_mesh", [("tp2", "1x1"), ("tp2", "1x2"),
                                            ("dp2tp2", "1x1")])
def test_tp_full_step_equals_jax(tp, group, jax_mesh):
    """Full fine-tuning at --tp 2 (and at data 2 x model 2) against JAX's
    make_train_step on one device and on create_mesh(data=1, model=2) with
    param_shardings: JAX tests/test_sharding.py's tolerance, loss rtol 1e-5
    and parameters atol 2e-5; grad_norm rtol 1e-4 (the split leaves' squares
    add in another order); the token count is the global batch's."""
    jstate, jm = tp[f"jax_full_{jax_mesh}"]
    for r, rank in enumerate(tp[group]):
        for i, (ours, ref) in enumerate(zip(rank["full"]["metrics"], jm)):
            _close(ours["loss"], ref["loss"], f"rank {r} step {i} loss")
            _close(ours["grad_norm"], ref["grad_norm"], f"rank {r} step {i}", rtol=1e-4)
            assert int(ours["tokens"]) == int(ref["tokens"])
    ref = JIO._flatten(jstate["params"])
    for r, arrays in enumerate(tp[group + "_arrays"]):
        for k, v in ref.items():
            _close(arrays[f"full/params/{k}"], np.asarray(v), f"rank {r} {k}", rtol=0,
                   atol=2e-5)


# ------------------------------------------------------------------ (c)

def test_dp2_tp2_peft_w8a8_calibrated_equals_jax(tp):
    """Data 2 x model 2, PEFT AdaLoRA over the int8 base with W8A8 and
    calibrated outliers. The calibrated sets equal JAX's and one process's
    (each rank records the whole K's column amax under the logical class),
    and every rank holds their rank masks. Against one process of the port,
    two steps: loss and orth_reg rtol 1e-5, grad_norm rtol 1e-4, adapters
    within 0.1 lr (the first reading 0.023 lr: a product over a rank's
    columns rounds its fp32 sums otherwise than over all of them, which
    flips an int8 rounding now and then, and Adam moves an element whose
    gradient is near 0 by up to lr whatever its size). Against JAX on
    create_mesh(data=2, model=2): loss and grad_norm rtol 2e-4, adapters
    within 0.5 lr; one process of the port is as far from JAX (loss 3.4e-5
    and 6.2e-5, grad_norm 2.7e-5 and 5.0e-5, adapters 0.14 lr): the two
    frameworks' fp32 activations differ in the last bits, which flips an
    int8 rounding of an activation now and then (tests/test_torch_peft.py
    holds the W8A8 forward to JAX within 2e-2)."""
    jstate, jm = tp["jax_peft_2x2"]
    metrics, trees, idx = tp["one_process_peft"]
    want = {f"{k[0]}x{k[1]}": list(v) for k, v in tp["jax_calibrated"].items()}
    assert any(want.values()) and idx == tp["jax_calibrated"]
    worker = _load_worker()
    lr = worker.LR
    for r, (rank, arrays) in enumerate(zip(tp["dp2tp2"], tp["dp2tp2_arrays"])):
        assert rank["peft"]["calibrated"] == want, r
        for i, (ours, one, ref) in enumerate(zip(rank["peft"]["metrics"], metrics, jm)):
            _close(ours["loss"], one["loss"], f"rank {r} step {i} loss")
            _close(ours["orth_reg"], one["orth_reg"], f"rank {r} step {i} orth_reg")
            _close(ours["grad_norm"], one["grad_norm"], f"rank {r} step {i}", rtol=1e-4)
            assert ours["tokens"] == one["tokens"] == ref["tokens"]
            _close(ours["loss"], ref["loss"], f"rank {r} step {i} loss (JAX)", rtol=2e-4)
            _close(ours["grad_norm"], ref["grad_norm"], f"rank {r} step {i} (JAX)", rtol=2e-4)
        for k, v in JIO._flatten(jstate["adapters"]).items():
            got = arrays[f"peft/adapters/{k}"]
            _close(got, trees["adapters"][k], f"rank {r} {k}", rtol=0, atol=0.1 * lr)
            _close(got, np.asarray(v), f"rank {r} {k} (JAX)", rtol=0, atol=0.5 * lr)
        for k, v in JIO._flatten(jstate["rank_mask"]).items():
            np.testing.assert_array_equal(arrays[f"peft/rank_mask/{k}"], np.asarray(v))
            np.testing.assert_array_equal(trees["rank_mask"][k], np.asarray(v))


def test_dp2_tp2_dynamic_outliers_rank_over_the_global_batch(tp):
    """Data 2 x model 2, PEFT over the int8 base with W8A8 in its dynamic
    top-k form (no calibration): each product ranks the column amax of the
    whole global batch (the max over the data group, then gathered over
    the model group for a row-split product), as one process and the JAX
    product over a batch split over "data" do, so two steps equal one
    process's: loss rtol 1e-5, grad_norm rtol 1e-4, adapters within 0.1 lr
    (as the calibrated case above)."""
    metrics, trees, _ = tp["one_process_peft_dynamic"]
    lr = _load_worker().LR
    for r, (rank, arrays) in enumerate(zip(tp["dp2tp2"], tp["dp2tp2_arrays"])):
        for i, (ours, one) in enumerate(zip(rank["peft_dynamic"]["metrics"], metrics)):
            _close(ours["loss"], one["loss"], f"rank {r} step {i} loss")
            _close(ours["grad_norm"], one["grad_norm"], f"rank {r} step {i}", rtol=1e-4)
        for k, v in trees["adapters"].items():
            _close(arrays[f"peft_dynamic/adapters/{k}"], v, f"rank {r} {k}", rtol=0,
                   atol=0.1 * lr)


# ------------------------------------------------------------------ (d)

@pytest.mark.parametrize("form", ["plain", "static", "dynamic"])
def test_row_split_w8a8_equals_the_whole_product(tp, form):
    """The W8A8 product split by input rows over two ranks (each its 64 of
    K = 128 columns, the row scale from the whole row's amax, the
    calibrated set re-based to the rank's columns, the dynamic top-k over
    the all-gathered column amax), summed over the ranks, equals the whole
    product within rtol 1e-5 (the same int8 operands; only the fp32
    epilogue and the outliers' side product round two partial sums instead
    of one: the first reading 4.8e-6, a few ulps); with each slice's own
    row amax it does not (the loud columns sit in one half)."""
    whole = tp["w8a8_whole"][form]
    for r, arrays in enumerate(tp["tp2_arrays"]):
        _close(arrays[f"w8a8/{form}"], whole, f"rank {r} {form}", rtol=1e-5, atol=1e-6)
        if form == "plain":
            assert not np.allclose(arrays["w8a8/own_scale"], whole, rtol=1e-3)


# ------------------------------------------------------------------ (e)

def test_tp2_checkpoint_resumes_in_one_process(tp):
    """The --tp 2 checkpoint holds whole parameters and moments (the files
    of one process), and one process resumes it at step 2 and runs to 4."""
    saved = _saved(tp["root"], "two", 2)
    one = _saved(tp["root"], "one", 2)
    assert saved["step"] == 2 and sorted(saved["params"]) == sorted(one["params"])
    for k, p in saved["params"].items():
        assert p.shape == one["params"][k].shape == saved["mu"][k].shape, k
    assert tp["two_to_one"]["final_step"] == 4
    resumed = _saved(tp["root"], "two_to_one", 4)
    assert resumed["step"] == 4 and resumed["opt_count"] == 4


def test_one_process_checkpoint_resumes_in_two_tp_ranks(tp):
    """Each rank restored its slices of a one-process checkpoint (parameters
    and moments), ran steps 3 and 4 at --tp 2, and its step-4 checkpoint
    equals one process's resume of the same checkpoint: parameters atol
    2e-5, loss rtol 1e-5."""
    for rank in tp["tp2"]:
        assert rank["restored_step"] == 2 and rank["restored_params_equal"]
        assert rank["restored_moments_equal"] and rank["restored_split"] > 0
        assert rank["resume"]["final_step"] == 4
    assert tp["tp2"][0]["resume"] == tp["tp2"][1]["resume"]
    two, one = _saved(tp["root"], "one_to_two", 4), _saved(tp["root"], "one_to_one", 4)
    for k, p in one["params"].items():
        _close(two["params"][k].numpy(), p.numpy(), k, rtol=0, atol=2e-5)
    _close(tp["tp2"][0]["resume"]["eval_loss"], tp["one_to_one"]["eval_loss"], "eval_loss")


# ------------------------------------------------------------------ (f)

@pytest.mark.parametrize("form", ["float", "peft_int8"])
def test_tp2_greedy_tokens_equal_one_process(tp, form):
    """fp32 greedy decodes on two ranks (the plain step over each rank's
    head, o and fc2 summed; over the int8 base with W8A8, 2 dynamic outlier
    columns and unmerged adapters too) give one process's tokens."""
    ref = tp["greedy_one"][form]
    for rank in tp["tp2"]:
        assert rank["greedy"][form] == ref


def test_tp2_eval_equals_one_process(tp):
    """cli.train --tp 2: both ranks print the same result, and its eval
    equals one process's evaluate() of the same shard from the ranks'
    step-2 checkpoint (loss rtol 1e-5; WER exactly). PEFT at --tp 2 (AdaLoRA,
    --int8_matmul, calibrated outliers) runs to its end alike on both."""
    a, b = (rank["cli"]["two"] for rank in tp["tp2"])
    assert a == b and a["final_step"] == 2
    ref = tp["one_process_eval"]
    assert a["eval_shard"] == ref["eval_shard"]
    _close(a["eval_loss"], ref["eval_loss"], "eval_loss")
    assert a["eval_wer"] == ref["eval_wer"]
    pa, pb = (rank["cli"]["two_peft"] for rank in tp["tp2"])
    assert pa == pb and pa["final_step"] == 2 and np.isfinite(pa["eval_loss"])
    saved = _saved(tp["root"], "two_peft", 2)
    assert "params" not in saved and "adapters" in saved


def test_train_hyper_at_tp2(tp):
    """A two-trial PEFT experiment of cli.train_hyper at --tp 2: each trial
    spans both ranks, both return the same summary, and both trials
    completed."""
    a, b = (rank["hyper"] for rank in tp["tp2"])
    assert a == b and a["best_trial"] in ("trial_0000", "trial_0001")
    state = json.loads((tp["root"] / "hpo" / "exp" / "experiment_state.json").read_text())
    assert sorted(state["trials"]) == ["trial_0000", "trial_0001"]
    assert all(t["status"] == "completed" for t in state["trials"].values())


# ------------------------------------------------------------------ (g)

def test_what_must_raise_under_tp(tp):
    """--tp 3 over two ranks raises (world % tp); under --tp 2 fused=True and
    ASR_TPU_FUSED_DECODE=1 raise, and the default decode is the plain
    step."""
    for rank in tp["tp2"]:
        ref = rank["refusals"]
        assert "tensor-parallel groups of 3" in ref["tp3"]
        assert "whole weights" in ref["fused_true"] and "whole weights" in ref["fused_env"]
        assert ref["fused_default"] is False


# ------------------------------------------------------------------ (h)

def test_tp2_offload_equals_resident(tp):
    """--offload_optimizer under --tp 2 against the resident run: the same
    result and the same checkpoint, bit for bit (on a CPU device nothing
    moves: chip_smoke.py phase 8 checks pinning on the card)."""
    for rank in tp["tp2"]:
        assert rank["cli"]["two_offload"] == rank["cli"]["two"]
    a, b = _saved(tp["root"], "two_offload", 2), _saved(tp["root"], "two", 2)
    for t in ("params", "mu", "nu"):
        for k in b[t]:
            assert torch.equal(a[t][k], b[t][k]), (t, k)

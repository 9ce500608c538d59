"""Data parallelism in the port (asr_finetune_tpu_torch/parallel/, the
data-parallel train step, ZeRO, host offload, the trainer's evaluation and
logging over ranks, checkpoints across world sizes, `cli.train` under
torchrun and `cli.train_hyper` under COORDINATOR_ADDRESS), on the CPU with
gloo, against the JAX package where it has the function and against one
process on the same global batch.

One module fixture starts two process pairs at once, each process with a
timeout of its own: tests/_torch_dp_worker.py under COORDINATOR_ADDRESS
(train steps on each rank's rows, a two-trial HPO experiment, the resume
of a one-process checkpoint) and `torchrun --nproc_per_node 2 -m
asr_finetune_tpu_torch.cli.train` (test-nano full fine-tuning with an
eval and a checkpoint). Meanwhile the test process computes the JAX and
one-process references."""
import csv
import importlib.util
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
from jax.sharding import NamedSharding, PartitionSpec

from asr_finetune_tpu.data import pipeline as JP
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
from asr_finetune_tpu_torch.data.pipeline import IndexSampler
from asr_finetune_tpu_torch.parallel import mesh, sharding

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "_torch_dp_worker.py"
# 64-dim heads, as every released Whisper; 150 encoder frames
SMALL = dict(vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
             encoder_heads=2, decoder_layers=2, decoder_heads=2, d_ff=256,
             max_source_positions=150, max_target_positions=32,
             eos_token_id=290, sot_token_id=291, translate_token_id=293,
             transcribe_token_id=294, no_timestamps_token_id=295,
             timestamp_begin_id=296, pad_token_id=290, first_language_token_id=292)
N_STEPS = 2
PROC_TIMEOUT = 300
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT", "COORDINATOR_ADDRESS", "ip_head", "SLURM_PROCID", "SLURM_NTASKS",
            "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE")


def _load_worker():
    spec = importlib.util.spec_from_file_location("_torch_dp_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=str(REPO), **extra)
    return env


def _batches(n: int, B: int = 4, T: int = 12):
    """Global batches; rank 0's rows (0, 1) hold fewer label tokens than rank
    1's, so the global token mean differs from the mean of the ranks' means."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        toks = rng.integers(0, 289, (B, T)).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], np.full((B, 1), 290, np.int32)], axis=1)
        labels[0, -5:] = -100
        labels[1, -2:] = -100
        out.append({"mel": rng.standard_normal((B, 300, 16)).astype(np.float32),
                    "decoder_input_ids": toks, "labels": labels})
    return out


def _write_folder(d: pathlib.Path, n: int = 6) -> str:
    d.mkdir()
    rng = np.random.default_rng(0)
    texts = ["Wir sind nach Hause gegangen.", "Die Schule war klein.",
             "Mein Vater hat erzählt.", "Das Dorf lag am Fluss.",
             "Später kam die Arbeit.", "Ich weiß es nicht mehr."]
    with open(d / "metadata.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "transcription"])
        for i in range(n):
            sig = rng.standard_normal(int(16000 * rng.uniform(0.5, 1.5))) * 0.1
            with wave.open(str(d / f"u{i}.wav"), "wb") as wf:
                wf.setnchannels(1)
                wf.setsampwidth(2)
                wf.setframerate(16000)
                wf.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())
            w.writerow([f"u{i}.wav", texts[i % len(texts)]])
    return str(d)


def _nano(folder, out, batch, *extra):
    """test-nano full fine-tuning, 4 train / 2 validation utterances, eval
    batch 2, eval + save every 2 steps, a constant lr."""
    return ["--model_type", "test-nano", "--device", "cpu", "--data_mode", "folder",
            "--dataset_name", folder, "--val_split", "0.34",
            "--per_device_train_batch_size", str(batch), "--per_device_eval_batch_size", "2",
            "--max_steps", "2", "--eval_steps", "2", "--save_steps", "2",
            "--logging_steps", "1", "--learning_rate", "1e-3",
            "--lr_scheduler_type", "constant", "--generation_max_length", "8",
            "--wer_weight", "0.7", "--num_to_keep", "3", "--output_dir", str(out),
            "--output_tag", "run", "--random_seed", "3", *extra]


def _peft(*extra):
    return ("--peft", "--load_in_8bit", "--adalora", "--lora_rank", "4", "--lora_alpha", "8",
            *extra)


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
    """The JAX parameters, int8 base and adapters (b moved off zero so every
    term of the delta is live), flattened for the port."""
    jcfg = JConfig(**SMALL)
    jparams = JW.init_params(jax.random.PRNGKey(3), jcfg)
    jbase = JQ.quantize_tree_int8(jparams)
    lcfg = JL.LoraConfig(rank=4, alpha=8.0, dropout=0.0, adalora=True, delta_t=1)
    jad = JL.init_adapters(jax.random.PRNGKey(4), jcfg, lcfg, encoder=True)
    b_rng = np.random.default_rng(9)
    jad = jax.tree_util.tree_map_with_path(
        lambda p, a: a + jnp.asarray(0.02 * b_rng.standard_normal(a.shape), jnp.float32)
        if p[-1].key == "b" else a, jad)
    return jcfg, jparams, jbase, jad, lcfg


def _jax_dp_steps(jcfg, state, tx, step_cfg, batches):
    """JAX's make_train_step on create_mesh(data=2), the batch sharded over
    the data axis and the state replicated."""
    m2 = JM.create_mesh(data=2, devices=jax.devices()[:2])
    state = jax.device_put(state, NamedSharding(m2, PartitionSpec()))
    step = jax.jit(JTS.make_train_step(jcfg, tx, step_cfg))
    metrics = []
    for b in batches:
        sharded = {k: jax.device_put(jnp.asarray(v), JM.batch_sharding(m2))
                   for k, v in b.items()}
        state, m = step(state, sharded)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    root = tmp_path_factory.mktemp("dp")
    worker = _load_worker()
    jcfg, jparams, jbase, jad, lcfg = _jax_inputs()
    batches = _batches(N_STEPS)
    arrays = {**{f"full/{k}": np.asarray(v) for k, v in JIO._flatten(jparams).items()},
              **{f"base/{k}": np.asarray(v) for k, v in JIO._flatten(jbase).items()},
              **{f"adapters/{k}": np.asarray(v) for k, v in JIO._flatten(jad).items()},
              **{f"batch{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()}}
    np.savez(root / "inputs.npz", **arrays)
    folder = _write_folder(root / "folder")

    # a one-process checkpoint for the two ranks to resume
    one = root / "one"
    train_cli.main(_nano(folder, one, 2))
    shutil.copytree(one, root / "one_to_two")
    spec = {"small": SMALL, "n_steps": N_STEPS,
            "hyper_argv": _nano(folder, root / "out", 1, *_peft(
                "--storage_path", str(root / "hpo"), "--num_samples", "2",
                "--hyperparameters", "learning_rate,rank", "--max_steps", "4",
                "--grace_period", "2", "--output_tag", "exp")),
            "resume_argv": _nano(folder, root / "one_to_two", 1, "--resume_training",
                                 "--max_steps", "4")}
    (root / "spec.json").write_text(json.dumps(spec))

    port = _free_port()
    workers = [subprocess.Popen(
        [sys.executable, str(WORKER), str(root)], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=_env(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", RANK=str(r), WORLD_SIZE="2"))
        for r in range(2)]
    two = root / "two"
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
         "-m", "asr_finetune_tpu_torch.cli.train", *_nano(folder, two, 1)],
        cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env())

    out = {"root": root, "folder": folder, "batches": batches, "arrays": arrays}
    try:
        # the references, while the ranks run
        kw = dict(scheduler="linear", warmup_steps=1, weight_decay=0.01, max_grad_norm=1.0)
        tx = JO.make_optimizer(worker.LR, 10, **kw)
        out["jax_full"] = _jax_dp_steps(jcfg, JTS.make_train_state(jparams, tx), tx,
                                        JTS.TrainStepConfig(mode="full",
                                                            compute_dtype=jnp.float32,
                                                            remat=False), batches)
        ptx = JO.make_optimizer(worker.LR, worker.MAX_STEPS,
                                trainable_mask=JO.adapter_freeze_mask(jad, True), **kw)
        out["jax_peft"] = _jax_dp_steps(
            jcfg, JTS.make_train_state(jbase, ptx, adapters=jad, adalora=True), ptx,
            JTS.TrainStepConfig(mode="peft", compute_dtype=jnp.float32, remat=False,
                                lora=lcfg, max_steps=worker.MAX_STEPS), batches)
        npz = np.load(root / "inputs.npz")
        out["one_process"] = {kind: worker.run_steps(npz, SMALL, kind, N_STEPS)
                              for kind in ("full_spec_augment", "peft", "peft_dropout")}
    finally:
        logs = _communicate(workers, "worker") + _communicate([torchrun], "torchrun")
    out["ranks"] = [json.loads((root / f"rank{r}.json").read_text()) for r in range(2)]
    out["rank_arrays"] = [dict(np.load(root / f"rank{r}.npz")) for r in range(2)]
    out["torchrun_results"] = [json.loads(line) for line in logs[-1].splitlines()
                               if line.startswith("{") and '"final_step"' in line]

    # the same shard evaluated in one process from the two ranks' step-2 state
    args = config_lib.parse_args(_nano(folder, root / "two_eval", 1))
    shutil.copytree(two, root / "two_eval")
    trainer = run_lib.setup_trial(args)
    try:
        trainer.state = trainer.checkpoints.restore(trainer.state, 2)
        out["one_process_eval"] = trainer.evaluate(2)
    finally:
        trainer.metrics.close()
    # the two ranks' checkpoint resumed by one process at the same global batch
    shutil.copytree(two, root / "two_to_one")
    out["two_to_one"] = train_cli.main(_nano(folder, root / "two_to_one", 2,
                                             "--resume_training", "--max_steps", "4"))
    torch.set_num_threads(n)
    return out


def _close(ours, ref, what, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol, err_msg=what)


# ------------------------------------------------------------------ (a)

def test_two_rank_full_step_equals_jax_data_parallel(dp):
    """Two ranks of full fine-tuning (ZeRO-split moments) against JAX's
    make_train_step on create_mesh(data=2) with the batch sharded, two
    steps: JAX tests/test_sharding.py's tolerance, loss rtol 1e-5 and
    parameters atol 2e-5; grad_norm rtol 1e-4 (tests/test_torch_train_step.py);
    the token count is the global batch's."""
    jstate, jm = dp["jax_full"]
    for r, rank in enumerate(dp["ranks"]):
        for i, (ours, ref) in enumerate(zip(rank["full"]["metrics"], jm)):
            _close(ours["loss"], ref["loss"], f"rank {r} step {i} loss")
            _close(ours["grad_norm"], ref["grad_norm"], f"rank {r} step {i}", rtol=1e-4)
            assert int(ours["tokens"]) == int(ref["tokens"])
    ref = JIO._flatten(jstate["params"])
    for r, arrays in enumerate(dp["rank_arrays"]):
        for k, v in ref.items():
            _close(arrays[f"full/params/{k}"], np.asarray(v), f"rank {r} {k}", rtol=0,
                   atol=2e-5)
    # ZeRO: the moments of the large leaves are split in halves
    full = [list(np.shape(dp["arrays"][f"full/{k}"])) for k in sorted(ref)]
    ours = dp["ranks"][0]["full"]["moment_shapes"]
    assert any(a != b for a, b in zip(ours, full))
    assert sum(np.prod(s) for s in ours) < sum(np.prod(s) for s in full)


def test_two_rank_peft_adalora_step_equals_jax_data_parallel(dp):
    """Two ranks of PEFT AdaLoRA over the int8 base (dropout 0) against JAX
    on create_mesh(data=2): loss and orth_reg rtol 1e-5, grad_norm rtol
    1e-4, adapters atol 2e-5, and every rank holds JAX's rank masks."""
    jstate, jm = dp["jax_peft"]
    for r, rank in enumerate(dp["ranks"]):
        for i, (ours, ref) in enumerate(zip(rank["peft"]["metrics"], jm)):
            _close(ours["loss"], ref["loss"], f"rank {r} step {i} loss")
            _close(ours["orth_reg"], ref["orth_reg"], f"rank {r} step {i} orth_reg")
            _close(ours["grad_norm"], ref["grad_norm"], f"rank {r} step {i}", rtol=1e-4)
    for r, arrays in enumerate(dp["rank_arrays"]):
        for k, v in JIO._flatten(jstate["adapters"]).items():
            _close(arrays[f"peft/adapters/{k}"], np.asarray(v), f"rank {r} {k}", rtol=0,
                   atol=2e-5)
        for k, v in JIO._flatten(jstate["rank_mask"]).items():
            np.testing.assert_array_equal(arrays[f"peft/rank_mask/{k}"], np.asarray(v))


# ------------------------------------------------------------------ (b)

def test_spec_augment_two_ranks_equal_one_process(dp):
    """Full fine-tuning with SpecAugment: each rank draws the global batch's
    masks and keeps its rows, so two ranks of 2 rows mask as one process of
    4 does: loss rtol 1e-6, grad_norm rtol 1e-5 and parameters atol 2e-6 as
    the PEFT comparisons below; and the masks moved the loss."""
    metrics, trees, _ = dp["one_process"]["full_spec_augment"]
    for r, rank in enumerate(dp["ranks"]):
        for i, (ours, ref) in enumerate(zip(rank["full_spec_augment"]["metrics"], metrics)):
            _close(ours["loss"], ref["loss"], f"rank {r} step {i} loss", rtol=1e-6)
            _close(ours["grad_norm"], ref["grad_norm"], f"rank {r} step {i}", rtol=1e-5)
            assert ours["tokens"] == ref["tokens"]
        assert rank["full_spec_augment"]["metrics"][0]["loss"] != \
            rank["full"]["metrics"][0]["loss"]
    for r, arrays in enumerate(dp["rank_arrays"]):
        for k, v in trees["params"].items():
            _close(arrays[f"full_spec_augment/params/{k}"], v, f"rank {r} {k}", rtol=0,
                   atol=2e-6)


@pytest.mark.parametrize("kind", ["peft", "peft_dropout"])
def test_two_ranks_equal_one_process_on_the_global_batch(dp, kind):
    """Two ranks against one process over the same global batches, with lora
    dropout off and on (rate 0.1: each rank draws the global batch's masks
    and takes its rows): loss, orth_reg rtol 1e-6 and grad_norm rtol 1e-5
    (only the sums over the ranks' rows are ordered otherwise); adapters
    atol 2e-6, 0.02 lr, the one-process tests' bound against JAX (Adam
    divides tiny gradients by their own RMS); equal rank masks."""
    metrics, trees, _ = dp["one_process"][kind]
    for r, rank in enumerate(dp["ranks"]):
        for i, (ours, ref) in enumerate(zip(rank[kind]["metrics"], metrics)):
            _close(ours["loss"], ref["loss"], f"rank {r} step {i} loss", rtol=1e-6)
            _close(ours["orth_reg"], ref["orth_reg"], f"rank {r} step {i}", rtol=1e-6)
            _close(ours["grad_norm"], ref["grad_norm"], f"rank {r} step {i}", rtol=1e-5)
            assert ours["tokens"] == ref["tokens"]
        arrays = dp["rank_arrays"][r]
        for k, v in trees["adapters"].items():
            _close(arrays[f"{kind}/adapters/{k}"], v, f"rank {r} {k}", rtol=0, atol=2e-6)
        for k, v in trees["rank_mask"].items():
            np.testing.assert_array_equal(arrays[f"{kind}/rank_mask/{k}"], v)
    if kind == "peft_dropout":   # the masks are on: the losses moved
        off = dp["one_process"]["peft"][0]
        assert all(a["loss"] != b["loss"] for a, b in zip(metrics, off))


# ------------------------------------------------------------------ (c)

@pytest.mark.parametrize("data", [2, 8])
@pytest.mark.parametrize("model", ["test-nano", "large-v3"])
def test_zero_partition_matches_jax(data, model):
    """The port's ZeRO rule picks JAX zero_shardings' leaves and axes: every
    leaf of the parameter tree (whose shapes the moments share), at full
    large-v3 shapes (abstract) and at test-nano's, over 2 and 8 ranks."""
    m = JM.create_mesh(data=data, devices=jax.devices()[:data])
    cfg = jax_config(model)
    shapes = jax.eval_shape(lambda: JW.init_params(jax.random.PRNGKey(0), cfg))
    pairs = zip(jax.tree_util.tree_leaves_with_path(JS.zero_shardings(shapes, m)),
                jax.tree.leaves(shapes))
    split = 0
    for (path, s), leaf in pairs:
        axes = [i for i, a in enumerate(s.spec) if a == JM.DATA_AXIS]
        ours = sharding.zero_axis(leaf.shape, data)
        assert ours == (axes[0] if axes else None), jax.tree_util.keystr(path)
        split += ours is not None
    assert split > 0


def test_leaf_shards_cover_the_leaf_once():
    """Each rank's slices tile a split leaf; one rank holds the whole leaf."""
    t = torch.arange(4 * 6 * 1000, dtype=torch.float32).reshape(4, 6, 1000)
    for world in (1, 2, 3, 8):
        parts = [sharding.LeafShard.of_shape(t.shape, r, world) for r in range(world)]
        if world == 1:
            assert parts[0].axis is None and parts[0].of(t) is t
            continue
        axis = parts[0].axis
        assert axis == {2: 2, 3: 1, 8: 2}[world] == sharding.zero_axis(t.shape, world)
        got = torch.cat([p.of(t) for p in parts], dim=axis)
        assert torch.equal(got, t)


# ------------------------------------------------------------------ (d)

@pytest.mark.parametrize("grouped", [False, True])
def test_sampler_shards_match_jax(grouped):
    """IndexSampler's process shards equal JAX IndexSampler's: every seed,
    process count and index, with and without length grouping, per epoch
    and resumed at a global step."""
    lengths = np.random.default_rng(0).integers(5, 200, 103)
    for seed in (0, 1, 7):
        for count in (1, 2, 3):
            for index in range(count):
                kw = dict(seed=seed, process_index=index, process_count=count,
                          lengths=lengths if grouped else None)
                ours, ref = IndexSampler(103, 4, **kw), JP.IndexSampler(103, 4, **kw)
                for epoch in (0, 1):
                    np.testing.assert_array_equal(ours.epoch_indices(epoch),
                                                  ref.epoch_indices(epoch))
                a, b = ours.batches_from_step(11), ref.batches_from_step(11)
                for _ in range(12):
                    np.testing.assert_array_equal(next(a), next(b))


# ------------------------------------------------------------------ (e)

@pytest.mark.parametrize("mode", ["full", "peft"])
def test_offload_equals_resident_and_moves_nothing_on_the_cpu(dp, tmp_path, mode):
    """--offload_optimizer (and in PEFT --offload_param) against the resident
    run: the same losses, grad norms and eval metrics bit for bit, and the
    same checkpoint. On a CPU device the state already lives on the host:
    the placement copies and pins nothing (pinning is checked on the card,
    chip_smoke.py phase 8)."""
    extra = _peft("--int8_matmul") if mode == "peft" else ()
    flags = ("--offload_optimizer",) + (("--offload_param",) if mode == "peft" else ())
    runs = {}
    for name, more in (("resident", ()), ("offload", flags)):
        train_cli.main(_nano(dp["folder"], tmp_path / name, 2, *extra, *more))
        with open(tmp_path / name / "run" / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        runs[name] = ([{k: v for k, v in r.items() if k in (
            "loss", "grad_norm", "eval_loss", "eval_wer", "eval_loss_wer")} for r in recs],
            torch.load(tmp_path / name / "run" / "checkpoints" / "step_00000002" / "state.pt",
                       weights_only=True))
    assert runs["offload"][0] == runs["resident"][0]
    saved, ref = runs["offload"][1], runs["resident"][1]
    assert sorted(saved) == sorted(ref)
    for t in ("mu", "nu", "adapters" if mode == "peft" else "params"):
        for k in ref[t]:
            assert torch.equal(saved[t][k], ref[t][k]), (t, k)
    cpu = sharding.Placement(torch.device("cpu"), offload_optimizer=True, offload_param=True)
    t = torch.ones(3)
    assert cpu.host(t) is t and not cpu.moment_zeros(t).is_pinned()
    tree = {"a": {"w": t}}
    cpu.base_to_host_(tree)
    assert tree["a"]["w"] is t and cpu.base_on_device(tree) is tree


# ------------------------------------------------------------------ (f)

def test_two_rank_eval_is_the_same_on_both_ranks_and_in_one_process(dp):
    """torchrun's two ranks print the same result, eval metrics included;
    they equal one process's evaluate() of the same shard from the ranks'
    step-2 state (loss rtol 1e-5: the ranks' sums are added in another
    order; WER exactly)."""
    a, b = dp["torchrun_results"]
    assert a == b and a["final_step"] == 2
    ref = dp["one_process_eval"]
    assert a["eval_shard"] == ref["eval_shard"]
    _close(a["eval_loss"], ref["eval_loss"], "eval_loss")
    assert a["eval_wer"] == ref["eval_wer"]
    _close(a["eval_loss_wer"], ref["eval_loss_wer"], "eval_loss_wer")


# ------------------------------------------------------------------ (g)

def test_two_rank_checkpoint_resumes_whole_in_one_process(dp):
    """The ranks' checkpoint holds whole moments (each as its parameter's
    shape, though the ranks held halves), and one process resumes it at
    step 2 and runs to 4."""
    saved = torch.load(dp["root"] / "two" / "run" / "checkpoints" / "step_00000002" /
                       "state.pt", weights_only=True)
    assert saved["step"] == 2
    for k, p in saved["params"].items():
        assert saved["mu"][k].shape == p.shape == saved["nu"][k].shape, k
    assert dp["two_to_one"]["final_step"] == 4
    resumed = torch.load(dp["root"] / "two_to_one" / "run" / "checkpoints" / "step_00000004" /
                         "state.pt", weights_only=True)
    assert resumed["step"] == 4 and resumed["opt_count"] == 4


def test_one_process_checkpoint_restores_into_two_ranks(dp):
    """Each rank restored its slice of the one-process checkpoint's moments
    (some leaves split), then the ranks ran steps 3 and 4 and saved whole."""
    for rank in dp["ranks"]:
        assert rank["restored_step"] == 2 and rank["restored_slices_equal"]
        assert rank["restored_split"] > 0
        assert rank["resume"]["final_step"] == 4
    assert dp["ranks"][0]["resume"] == dp["ranks"][1]["resume"]
    saved = torch.load(dp["root"] / "one_to_two" / "run" / "checkpoints" / "step_00000004" /
                       "state.pt", weights_only=True)
    for k, p in saved["params"].items():
        assert saved["mu"][k].shape == p.shape, k


# ------------------------------------------------------------------ (h)

def test_every_rank_logs_its_host_file_and_rank0_carries_all_hosts(dp):
    """Rank 0 writes metrics.jsonl (one record a logging step, each with
    every rank's host<r>_rss_gb and host<r>_hbm_in_use_gb); every rank
    writes metrics_host<r>.jsonl with its process_index."""
    run = dp["root"] / "two" / "run"
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    logged = [r for r in recs if "loss" in r]
    assert [r["step"] for r in logged] == [1, 2]
    for r in logged:
        for h in (0, 1):
            assert r[f"host{h}_rss_gb"] > 0 and r[f"host{h}_hbm_in_use_gb"] == 0.0
    for h in (0, 1):
        host = [json.loads(line) for line in
                (run / f"metrics_host{h}.jsonl").read_text().splitlines()]
        assert [r["step"] for r in host] == [1, 2]
        assert all(r["process_index"] == h and r["host_rss_gb"] > 0 for r in host)


# ------------------------------------------------------------------ (i)

def test_train_hyper_over_two_processes(dp):
    """A two-trial nano experiment under COORDINATOR_ADDRESS: both ranks ran
    in one gloo group and return the same summary; one experiment_state.json
    records both trials; every trial has both ranks' host files."""
    a, b = (rank["hyper"] for rank in dp["ranks"])
    assert a == b and a["best_trial"] in ("trial_0000", "trial_0001")
    assert {r["backend"] for r in dp["ranks"]} == {"gloo"}
    assert [r["world"] for r in dp["ranks"]] == [2, 2]
    exp = dp["root"] / "hpo" / "exp"
    state = json.loads((exp / "experiment_state.json").read_text())
    assert sorted(state["trials"]) == ["trial_0000", "trial_0001"]
    assert all(t["status"] == "completed" for t in state["trials"].values())
    assert not list(exp.glob("*.tmp"))
    for t in ("trial_0000", "trial_0001"):
        assert (exp / t / "metrics_host0.jsonl").exists()
        assert (exp / t / "metrics_host1.jsonl").exists()
        assert (exp / t / "trial_manifest.json").exists()


# ------------------------------------------------- the group's environment

def test_launch_from_env_names_torchrun_slurm_and_the_coordinator():
    """torchrun's variables, the JAX names with RANK / WORLD_SIZE or under
    Slurm, and none (one process)."""
    L = mesh.launch_from_env
    assert L({}) == mesh.Launch()
    t = L({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
           "MASTER_ADDR": "h", "MASTER_PORT": "29500"})
    assert (t.rank, t.world, t.local_rank, t.local_world, t.init_method) == (
        1, 4, 1, 2, "env://")
    c = L({"COORDINATOR_ADDRESS": "10.0.0.1:8476", "RANK": "0", "WORLD_SIZE": "2"})
    assert (c.rank, c.world, c.init_method, c.source) == (
        0, 2, "tcp://10.0.0.1:8476", "COORDINATOR_ADDRESS")
    s = L({"ip_head": "10.0.0.2:6379", "SLURM_PROCID": "3", "SLURM_NTASKS": "4",
           "SLURM_LOCALID": "1", "SLURM_NTASKS_PER_NODE": "2(x2)"})
    assert (s.rank, s.world, s.local_rank, s.local_world, s.init_method) == (
        3, 4, 1, 2, "tcp://10.0.0.2:6379")
    # Slurm's variables alone name no rendezvous: one process
    assert L({"SLURM_PROCID": "0", "SLURM_NTASKS": "4"}) == mesh.Launch()


@pytest.mark.parametrize("env,match", [
    ({"COORDINATOR_ADDRESS": "localhost:1234"}, "COORDINATOR_ADDRESS is set but no process"),
    ({"ip_head": "localhost:1234"}, "ip_head is set but no process"),
    ({"COORDINATOR_ADDRESS": "localhost", "RANK": "0", "WORLD_SIZE": "2"}, "host:port"),
    ({"RANK": "0", "WORLD_SIZE": "2"}, "MASTER_ADDR"),
])
def test_launch_from_env_refuses_a_group_it_cannot_form(env, match):
    with pytest.raises(ValueError, match=match):
        mesh.launch_from_env(env)


def test_backend_is_nccl_only_for_one_card_a_rank(monkeypatch):
    """NCCL when each rank of a host has its own card, gloo when ranks share
    one and on the CPU; outside a group the collectives are the identity."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert mesh.backend_for(cuda, mesh.Launch(world=2, local_world=1, init_method="x")) == "nccl"
    assert mesh.backend_for(cuda, mesh.Launch(world=2, local_world=2, init_method="x")) == "gloo"
    assert mesh.backend_for(cpu, mesh.Launch(world=2, local_world=1, init_method="x")) == "gloo"
    assert not mesh.active() and mesh.world() == 1 and mesh.rank() == 0
    t = torch.ones(2)
    assert mesh.all_reduce_sum_(t) is t and torch.equal(t, torch.ones(2))
    assert mesh.all_gather_object("x") == ["x"] and mesh.broadcast_object(3) == 3
    assert mesh.local_device("cuda") == "cuda"

"""HPO in the port (asr_finetune_tpu_torch/hpo, cli/train_hyper.py, the
trainer's early-stop hook and run.run_trial's trial arguments) against the
JAX package on the CPU: the copied space, searchers and schedulers give the
same suggestions, decisions and states for the same seeds; the two
controllers, driven by one deterministic fake trial, write the same
experiment, scheduler, searcher and best-trial files in every search mode
and on resume; and real test-nano experiments and trials on --device cpu."""
import csv
import json
import os
import shutil
import types
import wave
import weakref

import numpy as np
import pytest
import torch

from asr_finetune_tpu import config as JC
from asr_finetune_tpu.hpo import controller as JCTL
from asr_finetune_tpu.hpo import schedulers as JSCH
from asr_finetune_tpu.hpo import search as JSE
from asr_finetune_tpu.hpo import space as JSP
from asr_finetune_tpu_torch import config as TC
from asr_finetune_tpu_torch import run as run_lib
from asr_finetune_tpu_torch.cli import train_hyper
from asr_finetune_tpu_torch.hpo import controller as TCTL
from asr_finetune_tpu_torch.hpo import schedulers as TSCH
from asr_finetune_tpu_torch.hpo import search as TSE
from asr_finetune_tpu_torch.hpo import space as TSP
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.training.checkpoint import (CheckpointManager,
                                                        load_trial_manifest)

PROD_HP = "learning_rate,weight_decay,lr_scheduler_type,rank,alpha"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """As tests/test_torch_train_cli.py: two intra-op threads keep the
    parallel workers from oversubscribing."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _space_args(**kw):
    base = dict(hyperparameters=None, warmup_steps=0, peft=False)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _domains(space):
    return {k: (type(d).__name__, tuple(getattr(d, "values", ())),
                getattr(d, "low", None), getattr(d, "high", None))
            for k, d in space.items()}


# ------------------------------------------------------------------ copies

@pytest.mark.parametrize("kw", [dict(peft=True), dict(peft=True, warmup_steps=10),
                                dict(hyperparameters=[["learning_rate", "rank", "alpha"]],
                                     peft=True),
                                dict(hyperparameters=[PROD_HP.split(",")], peft=True)])
def test_space_matches_jax(kw):
    """The same domains, and the same configs drawn from one seed."""
    ours, ref = TSP.get_whisper_hyperparameters(_space_args(**kw)), \
        JSP.get_whisper_hyperparameters(_space_args(**kw))
    assert _domains(ours) == _domains(ref)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(20):
        assert TSP.sample_config(ours, a) == JSP.sample_config(ref, b)


@pytest.mark.parametrize("mode", ["small_small", "large_small_OPTUNA", "large_small_BOHB"])
def test_searchers_match_jax(mode):
    """make_searcher's suggestions over 12 observed trials (TPE past its 5
    startup draws), and the state dicts, equal the JAX searcher's; a
    searcher restored from the JSON state continues the same stream."""
    args = _space_args(hyperparameters=[PROD_HP.split(",")], peft=True)
    ours = TSE.make_searcher(mode, TSP.get_whisper_hyperparameters(args), seed=11)
    ref = JSE.make_searcher(mode, JSP.get_whisper_hyperparameters(args), seed=11)
    assert type(ours).__name__ == type(ref).__name__
    for i in range(12):
        hp, hp_ref = ours.suggest(), ref.suggest()
        assert hp == hp_ref, i
        metric = abs(np.log10(hp["learning_rate"]) + 4.5) + 0.01 * hp["rank"]
        ours.observe(hp, metric)
        ref.observe(hp_ref, metric)
    assert json.loads(json.dumps(ours.state_dict())) == json.loads(json.dumps(ref.state_dict()))
    again = TSE.make_searcher(mode, TSP.get_whisper_hyperparameters(args), seed=0)
    again.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    assert [again.suggest() for _ in range(3)] == [ref.suggest() for _ in range(3)]


@pytest.mark.parametrize("mode,rf", [("min", 2), ("max", 3)])
def test_asha_matches_jax(mode, rf):
    """The same continue/stop decision for every result of 12 trials over
    three rungs, and the same state dict."""
    ours = TSCH.AshaScheduler(metric="m", mode=mode, max_t=20, grace_period=2,
                              reduction_factor=rf)
    ref = JSCH.AshaScheduler(metric="m", mode=mode, max_t=20, grace_period=2,
                             reduction_factor=rf)
    rng = np.random.default_rng(5)
    for t in range(12):
        for step in (2, 4, 6, 8, 12, 16):
            m = {"m": float(rng.standard_normal())}
            assert ours.on_result(f"t{t}", step, m) == ref.on_result(f"t{t}", step, m)
    assert ours.state_dict() == ref.state_dict()
    restored = TSCH.AshaScheduler(metric="m", mode=mode, max_t=20, grace_period=2,
                                  reduction_factor=rf)
    restored.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    assert restored.state_dict() == ref.state_dict()


@pytest.mark.parametrize("n,quantile", [(2, 0.5), (5, 0.25), (8, 0.25)])
def test_pbt_and_grace_period_match_jax(n, quantile):
    """exploit_explore's clones and perturbed hp, from one rng seed, and the
    grace-period heuristic."""
    rng = np.random.default_rng(3)
    pop = [{"trial_id": f"p{i}", "metric": float(rng.standard_normal()),
            "hp": {"learning_rate": float(rng.uniform(1e-5, 1e-4)),
                   "weight_decay": float(rng.uniform(0, 1e-2)), "rank": int(i + 1)}}
           for i in range(n)]
    ours = TSCH.PbtScheduler(metric="m", quantile_fraction=quantile)
    ref = JSCH.PbtScheduler(metric="m", quantile_fraction=quantile)
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        assert ours.exploit_explore(a, pop) == ref.exploit_explore(b, pop)
    for args in ((100, 8, True), (100000, 8, False), (80, 8, False), (n, 0, False)):
        assert TSCH.calculate_grace_period(*args) == JSCH.calculate_grace_period(*args)


# ------------------------------------------- the controllers, one fake trial

def _fake_trial(fail_once: set):
    """A deterministic stand-in for run.run_trial in both controllers: every
    eval step scores the hp and the value carried in the trial's latest
    checkpoint, saves it as checkpoints/step_N.json, and asks on_evaluate;
    a resumed trial (or a PBT member with a donor's checkpoints) goes on
    from its latest checkpoint. A trial named in fail_once raises once,
    after its first checkpoint."""
    def run_trial(args, hp=None, trial_dir=None, on_evaluate=None,
                  max_steps_override=None, resume_override=None, **_):
        ckpt = os.path.join(trial_dir, "checkpoints")
        os.makedirs(ckpt, exist_ok=True)
        steps = sorted(int(f[5:13]) for f in os.listdir(ckpt))
        start, acc = 0, 0.0
        if resume_override and steps:
            start = steps[-1]
            with open(os.path.join(ckpt, f"step_{start:08d}.json")) as f:
                acc = json.load(f)["acc"]
        result = {"final_step": start}
        for step in range(start + 1, (max_steps_override or args.max_steps) + 1):
            if step % args.eval_steps:
                continue
            acc = (0.9 * acc + abs(np.log10(hp.get("learning_rate", 1e-5)) + 4.5)
                   + 10.0 * hp.get("weight_decay", 0.0) + 0.01 * hp.get("rank", 8)
                   + (0.1 if hp.get("lr_scheduler_type") == "cosine" else 0.0))
            metrics = {"eval_loss": acc, "eval_loss_wer": acc + 1.0 / step}
            with open(os.path.join(ckpt, f"step_{step:08d}.json"), "w") as f:
                json.dump({"acc": acc}, f)
            result = {"final_step": step, **metrics}
            name = os.path.basename(trial_dir)
            if name in fail_once:
                fail_once.discard(name)
                raise RuntimeError(f"fake fault in {name}")
            if on_evaluate is not None and not on_evaluate(step, metrics):
                break
        return result
    return run_trial


STATE_FILES = ("experiment_state.json", "scheduler_state.json", "searcher_state.json",
               "best_result.json")


def _states(exp_dir):
    out = {}
    for name in STATE_FILES:
        path = os.path.join(exp_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                out[name] = json.load(f)
    out["error.txt"] = sorted(d for d in os.listdir(exp_dir)
                              if os.path.exists(os.path.join(exp_dir, d, "error.txt")))
    return out


@pytest.mark.parametrize("fail", [False, True])
@pytest.mark.parametrize("mode", ["small_small", "large_small_OPTUNA", "large_large"])
def test_controller_writes_the_jax_states(tmp_path, monkeypatch, mode, fail):
    """Both controllers under one fake trial: random search and TPE with
    ASHA (7 trials, rungs at steps 2 and 4 of 8), and PBT (4 members, 2
    segments of 4 steps, the bottom member cloning a donor's checkpoints).
    With `fail`, one trial raises once: the first run records it errored
    (with its error.txt), and a second run with --resume_training re-runs
    it from its checkpoint and skips the completed trials. After each run
    the experiment, scheduler, searcher and best-trial files are equal."""
    flags = ["--max_steps", "8", "--eval_steps", "2", "--save_steps", "2",
             "--num_samples", "4" if mode == "large_large" else "7",
             "--search_schedule_mode", mode, "--grace_period", "2",
             "--perturbation_interval", "4", "--hyperparameters", PROD_HP,
             "--peft", "--random_seed", "1337", "--output_tag", "exp"]
    failing = "pbt_0002" if mode == "large_large" else "trial_0003"
    runs = [[]] + ([["--resume_training"]] if fail else [])
    fakes = {p: _fake_trial({failing} if fail else set()) for p in ("jax", "port")}
    monkeypatch.setattr(JCTL.run_lib, "run_trial", fakes["jax"])
    monkeypatch.setattr(TCTL.run_lib, "run_trial", fakes["port"])
    for extra in runs:
        jargs = JC.parse_args(flags + extra + ["--storage_path", str(tmp_path / "jax")])
        targs = TC.parse_args(flags + extra + ["--storage_path", str(tmp_path / "port"),
                                               "--device", "cpu"])
        ref = JCTL.run_experiment(jargs)
        ours = TCTL.run_experiment(targs)
        assert json.loads(json.dumps(ours, default=str)) == \
            json.loads(json.dumps(ref, default=str))
        a, b = _states(tmp_path / "port" / "exp"), _states(tmp_path / "jax" / "exp")
        assert a == b
        assert a["best_result.json"]["best_trial"] is not None
        trials = a["experiment_state.json"]["trials"]
        if mode == "large_large":
            assert any(t.get("cloned_from") for t in trials.values())
        if fail:
            assert trials[failing]["error"] == f"fake fault in {failing}"
        if fail and not extra and mode != "large_large":
            assert trials[failing]["status"] == "errored" and a["error.txt"] == [failing]
        elif mode != "large_large":
            assert all(t["status"] == "completed" for t in trials.values())
            stopped = [t for t in trials.values() if t["result"]["final_step"] < 8]
            assert stopped, "ASHA stopped no trial"


def test_controller_refuses_more_than_one_slot(tmp_path, monkeypatch):
    """One process with several cards does not pack (the port runs one
    process per card): a --chips_per_trial that would run two trials at
    once on four cards raises before any trial, naming the torchrun launch
    that packs them over ranks (tests/test_torch_trial_packing.py runs
    one); a plan of one slot passes, and on --device cpu there is one
    slot. A trial given devices that are not one per rank of its group
    raises."""
    with pytest.raises(ValueError, match="2 devices in a trial group of 1"):
        run_lib.run_trial(TC.parse_args(["--device", "cpu"]), devices=["cpu", "cpu"])
    flags = ["--storage_path", str(tmp_path), "--num_samples", "2"]
    monkeypatch.setattr(TCTL, "resolve_device", lambda device: torch.device(device))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(TCTL.run_lib, "run_trial", lambda *a, **k: pytest.fail("ran"))
    for chips in ("1", "2"):
        args = TC.parse_args(flags + ["--chips_per_trial", chips,
                                      "--max_concurrent_trials", "2"])
        with pytest.raises(ValueError, match=f"torchrun --nproc_per_node 4 -m asr_finetune_"
                                             f"tpu_torch.cli.train_hyper --chips_per_trial "
                                             f"{chips} --max_concurrent_trials 2"):
            TCTL.run_experiment(args)
    assert TCTL.count_slots(TC.parse_args(flags + ["--chips_per_trial", "4"])) == 1
    assert TCTL.count_slots(TC.parse_args(flags + ["--chips_per_trial", "2"])) == 1
    assert TCTL.count_slots(TC.parse_args(flags + ["--device", "cpu",
                                                   "--chips_per_trial", "1",
                                                   "--max_concurrent_trials", "4"])) == 1


def test_train_hyper_refuses_multi_process_and_a_missing_card(tmp_path, monkeypatch):
    """A multi-process experiment joins its group (tests/test_torch_parallel.py
    runs one); COORDINATOR_ADDRESS or ip_head with no process count and rank
    to form a group with raises a clear error before any trial, and so does
    a missing card."""
    argv = ["--storage_path", str(tmp_path), "--num_samples", "1"]
    monkeypatch.setattr(TCTL.run_lib, "run_trial", lambda *a, **k: pytest.fail("ran"))
    for name in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    for var in ("COORDINATOR_ADDRESS", "ip_head"):
        with monkeypatch.context() as m:
            m.setenv(var, "localhost:1234")
            with pytest.raises(ValueError, match=f"{var} is set but no process count"):
                train_hyper.main(argv + ["--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_hyper.main(argv)


# ------------------------------------------------------ real port trials

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("hpo_audiofolder")
    rng = np.random.default_rng(0)
    texts = ["Wir sind nach Hause gegangen.", "Die Schule war klein.",
             "Mein Vater hat erzählt.", "Das Dorf lag am Fluss.",
             "Später kam die Arbeit.", "Ich weiß es nicht mehr."]
    with open(d / "metadata.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "transcription"])
        for i, text in enumerate(texts):
            sig = rng.standard_normal(int(16000 * rng.uniform(0.5, 1.5))) * 0.1
            with wave.open(str(d / f"u{i}.wav"), "wb") as wf:
                wf.setnchannels(1)
                wf.setsampwidth(2)
                wf.setframerate(16000)
                wf.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())
            w.writerow([f"u{i}.wav", text])
    return str(d)


def _argv(folder, tmp_path, *extra):
    """test-nano, AdaLoRA over the int8 base, 4 train / 2 validation
    utterances, batch 2, eval + save every 2 steps of 4, three checkpoints
    kept."""
    return ["--model_type", "test-nano", "--device", "cpu", "--data_mode", "folder",
            "--dataset_name", folder, "--val_split", "0.34",
            "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "2",
            "--max_steps", "4", "--eval_steps", "2", "--save_steps", "2",
            "--logging_steps", "1", "--generation_max_length", "8", "--num_to_keep", "3",
            "--output_dir", str(tmp_path / "out"), "--output_tag", "run",
            "--storage_path", str(tmp_path / "hpo"), "--random_seed", "3", "--peft",
            "--load_in_8bit", "--adalora", "--lora_rank", "4", "--lora_alpha", "8", *extra]


def test_nano_experiment_on_cpu_and_resume(folder, tmp_path, monkeypatch):
    """`cli.train_hyper --device cpu`: two random-search trials of test-nano
    PEFT, each at its own AdaLoRA rank; the hp sequence is the JAX
    RandomSearch stream for the seed; each trial's lora-dropout seed is
    seed + 7919·index; no trial's Trainer outlives its run_trial. Then
    --resume_training runs no trial and names the same best trial."""
    argv = _argv(folder, tmp_path, "--search_schedule_mode", "small_small",
                 "--num_samples", "2", "--hyperparameters", "learning_rate,rank",
                 "--grace_period", "2", "--output_tag", "exp")
    built, setup = [], run_lib.setup_trial

    def setup_trial(*a, **k):
        trainer = setup(*a, **k)
        built.append((trainer.step_cfg.seed, trainer.state["adapters"]["decoder"]
                      ["self_attn"]["q"]["a"].shape[-1], weakref.ref(trainer)))
        return trainer
    monkeypatch.setattr(run_lib, "setup_trial", setup_trial)
    summary = train_hyper.main(argv)
    exp = tmp_path / "hpo" / "exp"
    trials = json.loads((exp / "experiment_state.json").read_text())["trials"]
    assert sorted(trials) == ["trial_0000", "trial_0001"]
    assert all(t["status"] == "completed" for t in trials.values())
    jspace = JSP.get_whisper_hyperparameters(TC.parse_args(argv))
    rs = JSE.RandomSearch(jspace, seed=3)
    hps = [trials[t]["hp"] for t in sorted(trials)]
    assert hps == [rs.suggest(), rs.suggest()]
    assert [s for s, _, _ in built] == [3, 3 + 7919]
    assert [r for _, r, _ in built] == [h["rank"] for h in hps]
    assert all(ref() is None for _, _, ref in built)
    assert summary["best_trial"] in trials
    assert json.loads((exp / "best_result.json").read_text())["best_trial"] == \
        summary["best_trial"]
    manifest = load_trial_manifest(str(exp / summary["best_trial"]))
    assert manifest["hp"] == trials[summary["best_trial"]]["hp"]

    monkeypatch.setattr(run_lib, "run_trial", lambda *a, **k: pytest.fail("re-ran a trial"))
    again = train_hyper.main(argv + ["--resume_training"])
    assert again["best_trial"] == summary["best_trial"]


def test_pbt_clone_and_resume_over_port_checkpoints(folder, tmp_path):
    """PBT's exploit: a donor's port checkpoints (adapter-only, with
    AdaLoRA's rank mask and sensitivity) copied over a member's, which
    resumes from the donor's step under new hp and trains on to 4; the
    schedule keeps --max_steps while max_steps_override cuts the run."""
    donor, member = tmp_path / "donor", tmp_path / "member"
    args = TC.parse_args(_argv(folder, tmp_path))
    r1 = run_lib.run_trial(args, hp={"learning_rate": 1e-4}, trial_dir=str(donor),
                           max_steps_override=2, trial_index=0)
    assert r1["final_step"] == 2
    shutil.copytree(donor / "checkpoints", member / "checkpoints")
    assert CheckpointManager(str(member / "checkpoints")).latest_step() == 2
    r2 = run_lib.run_trial(args, hp={"learning_rate": 2e-4}, trial_dir=str(member),
                           max_steps_override=4, resume_override=True, trial_index=1)
    assert r2["final_step"] == 4
    with open(member / "metrics.jsonl") as f:
        steps = sorted({r["step"] for r in map(json.loads, f) if "loss" in r})
    assert steps == [3, 4]                      # went on from the donor's step 2
    saved = torch.load(member / "checkpoints" / "step_00000004" / "state.pt",
                       weights_only=True)
    assert saved["step"] == 4 and {"rank_mask", "sensitivity", "adapters"} <= set(saved)
    donor2 = torch.load(donor / "checkpoints" / "step_00000002" / "state.pt",
                        weights_only=True)
    assert any(not torch.equal(saved["adapters"][k], donor2["adapters"][k])
               for k in saved["adapters"])


def test_trainer_stops_early_after_the_eval_checkpoint(folder, tmp_path):
    """on_evaluate returning False at step 2 of 4: the step-2 checkpoint is
    saved first, the run stops, and the final save is labelled max_steps
    (4) holding step 2's state, as the JAX trainer does."""
    calls = []
    result = run_lib.run_trial(TC.parse_args(_argv(folder, tmp_path)),
                               trial_dir=str(tmp_path / "t"),
                               on_evaluate=lambda step, m: calls.append((step, m)) and False)
    assert result["final_step"] == 2 and [s for s, _ in calls] == [2]
    assert "eval_loss_wer" in calls[0][1]
    ck = CheckpointManager(str(tmp_path / "t" / "checkpoints"))
    assert ck.all_steps() == [2, 4]
    a, b = (torch.load(tmp_path / "t" / "checkpoints" / f"step_{s:08d}" / "state.pt",
                       weights_only=True) for s in (2, 4))
    assert a["step"] == b["step"] == 2
    for k, t in a["adapters"].items():
        assert torch.equal(t, b["adapters"][k])


def test_trial_seed_and_release(folder, tmp_path, monkeypatch):
    """The per-trial seed: trial_index 1 draws another lora-dropout mask
    than trial_index 0 (JAX: seed + 7919·index). A trial that raises
    leaves no Trainer alive while its exception is held."""
    args = TC.parse_args(_argv(folder, tmp_path))
    seeds = []
    for i in (0, 1):
        trainer = run_lib.setup_trial(args, trial_dir=str(tmp_path / f"s{i}"),
                                      trial_index=i)
        trainer.metrics.close()
        seeds.append(trainer.step_cfg.seed)
        del trainer
    assert seeds == [3, 3 + 7919]
    x = torch.ones((64, 32))
    m0, m1 = (TW.LoraDropout(0.05, s, 1)(x, "enc/0/q") for s in seeds)
    assert not torch.equal(m0, m1)

    refs = []
    setup = run_lib.setup_trial

    def setup_trial(*a, **k):
        trainer = setup(*a, **k)
        refs.append(weakref.ref(trainer))

        def boom(resume=False):
            raise RuntimeError("fault in the step")
        trainer.train = boom
        return trainer
    monkeypatch.setattr(run_lib, "setup_trial", setup_trial)
    with pytest.raises(RuntimeError, match="fault in the step") as info:
        run_lib.run_trial(args, trial_dir=str(tmp_path / "boom"))
    assert info.value.__traceback__ is not None and refs[0]() is None

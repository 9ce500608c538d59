"""Trial packing in the port (hpo/controller.py with --chips_per_trial and
--max_concurrent_trials over parallel/mesh.trial_groups) on the CPU.

(a) The slot plan against JAX's own `run_experiment` (its devices and
process count faked, its trial stubbed). (b)-(d): one module fixture
starts, all at once, a two-rank gloo group packing one-rank slots, a
four-rank group packing two-rank slots with a trial that fails on every
rank of its slot, and the one-process serial runs they are held to
(tests/_torch_trial_packing_worker.py, test-nano PEFT over the int8 base,
2 steps a trial). (e) One process with several cards refuses to pack.
And the experiment files under the lock, from more processes than cores.
"""
import csv
import json
import multiprocessing
import os
import pathlib
import queue
import socket
import subprocess
import sys
import wave

import jax
import numpy as np
import pytest
import torch

from asr_finetune_tpu import config as JC
from asr_finetune_tpu.hpo import controller as JCTL
from asr_finetune_tpu_torch import config as TC
from asr_finetune_tpu_torch.hpo import controller as TCTL
from asr_finetune_tpu_torch.hpo import search as TSE
from asr_finetune_tpu_torch.hpo.space import get_whisper_hyperparameters
from asr_finetune_tpu_torch.parallel import mesh
from _torch_trial_packing_worker import claim_all  # tests/, on sys.path under pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "_torch_trial_packing_worker.py"
PROC_TIMEOUT = 240
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT", "COORDINATOR_ADDRESS", "ip_head", "SLURM_PROCID", "SLURM_NTASKS",
            "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE")


# ------------------------------------------------------------------ (a)

def _jax_slots(tmp_path, monkeypatch, units, chips, conc, hosts):
    """The slots JAX's run_experiment puts in its queue, as unit indices,
    and whether it passed them to its trials (more than one slot)."""
    slots, passed = [], []

    class Recorder(queue.Queue):
        def put(self, item, *a, **k):
            if not passed:               # the plan is queued before any trial
                slots.append(list(item))
            super().put(item, *a, **k)

    def run_trial(args, hp=None, trial_dir=None, devices=None, **kw):
        passed.append(devices)
        return {"final_step": 1}
    monkeypatch.setattr(queue, "Queue", Recorder)
    monkeypatch.setattr(jax, "local_devices", lambda: list(range(units)))
    monkeypatch.setattr(jax, "process_count", lambda: hosts)
    monkeypatch.setattr(JCTL.run_lib, "run_trial", run_trial)
    JCTL.run_experiment(JC.parse_args([
        "--storage_path", str(tmp_path), "--output_tag", "exp", "--num_samples", "3",
        "--search_schedule_mode", "small_small", "--chips_per_trial", str(chips),
        "--max_concurrent_trials", str(conc)]))
    assert all(d is None for d in passed) == (len(slots) == 1)
    return slots


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("conc", [1, 2, 8])
@pytest.mark.parametrize("chips", [0, 0.5, 1, 2, 3, 4, 8])
@pytest.mark.parametrize("units", [1, 2, 4, 8])
def test_slot_plan_matches_jax(tmp_path, monkeypatch, units, chips, conc, hosts):
    """JAX's slots over a host's chips are the port's over a host's ranks:
    `slot_plan` gives the same units, and `trial_slots` under a launch of
    `units` ranks a host as many slots, each the ranks a JAX trial spans
    (its slot, or with one slot every chip of every host)."""
    ref = _jax_slots(tmp_path, monkeypatch, units, chips, conc, hosts)
    assert mesh.slot_plan(units, chips, conc, hosts) == ref
    monkeypatch.setattr(mesh, "active", lambda: True)
    monkeypatch.setattr(mesh, "global_world", lambda: units * hosts)
    monkeypatch.setattr(mesh, "launch_from_env", lambda: mesh.Launch(
        world=units * hosts, local_world=units, init_method="tcp://x:1"))
    ours = mesh.trial_slots(chips, conc)
    assert [len(s) for s in ours] == ([units * hosts] if len(ref) == 1
                                      else [len(s) for s in ref])
    assert sorted(r for s in ours for r in s) == list(range(sum(len(s) for s in ours)))


# ------------------------------------------------------------------ (e)

@pytest.mark.parametrize("cards,chips,conc,slots", [
    (4, "1", "2", 2), (8, "3", "8", 2), (2, "1", "8", 2),
    (4, "4", "2", 1), (4, "0.5", "2", 1), (8, "2", "1", 1)])
def test_one_process_with_several_cards_does_not_pack(tmp_path, monkeypatch, cards, chips,
                                                      conc, slots):
    """Outside a group a plan of more than one slot raises before any trial,
    naming the torchrun launch that packs; a plan of one slot passes."""
    monkeypatch.setattr(TCTL, "resolve_device", lambda device: torch.device(device))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(TCTL.run_lib, "run_trial", lambda *a, **k: pytest.fail("ran"))
    args = TC.parse_args(["--storage_path", str(tmp_path), "--num_samples", "2",
                          "--chips_per_trial", chips, "--max_concurrent_trials", conc])
    if slots == 1:
        assert TCTL.count_slots(args) == 1
        return
    with pytest.raises(ValueError, match=f"packs {slots} trials onto the {cards} cards.*"
                                         f"torchrun --nproc_per_node {cards}"):
        TCTL.run_experiment(args)


# ------------------------------------------------- the files under the lock

def test_claims_under_the_lock_from_more_processes_than_cores(tmp_path):
    """12 processes claim 60 trials at once through the experiment files:
    every index once, each with the hp a serial searcher suggests at that
    index (a lost update of the queue or the searcher's state would repeat
    an index or an hp), and every claim recorded running."""
    n, procs = 60, 12
    argv = ["--storage_path", str(tmp_path), "--output_tag", "exp", "--num_samples", str(n),
            "--search_schedule_mode", "small_small", "--random_seed", "5", "--device", "cpu"]
    args = TC.parse_args(argv)
    exp = str(tmp_path / "exp")
    os.makedirs(exp)
    files = TCTL._Files(exp, shared=True)
    space = get_whisper_hyperparameters(args)
    TCTL._start(args, files, space, "eval_loss_wer", "min")
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(procs) as pool:
        parts = [pool.apply_async(claim_all, (argv, exp)) for _ in range(procs)]
        claims = [c for p in parts for c in p.get(timeout=120)]
    rs = TSE.RandomSearch(space, seed=5)
    serial = [rs.suggest() for _ in range(n)]
    assert sorted(i for i, _ in claims) == list(range(n))
    assert all(json.loads(json.dumps(serial[i])) == hp for i, hp in claims)
    state = json.loads((tmp_path / "exp" / "experiment_state.json").read_text())["trials"]
    assert sorted(state) == [f"trial_{i:04d}" for i in range(n)]
    assert all(t["status"] == "running" for t in state.values())
    assert json.loads((tmp_path / "exp" / "trial_queue.json").read_text()) == {"next": n}


# ----------------------------------------------------------- (b)-(d): ranks

def _write_folder(d: pathlib.Path) -> str:
    d.mkdir()
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


def _argv(folder, root, batch, samples, *extra):
    """test-nano AdaLoRA over the int8 base, random search over the learning
    rate and the rank, 4 train / 2 validation utterances, 2 steps of
    `batch` rows a rank with an eval (greedy WER) and a checkpoint at 2."""
    return ["--model_type", "test-nano", "--device", "cpu", "--data_mode", "folder",
            "--dataset_name", folder, "--val_split", "0.34",
            "--per_device_train_batch_size", str(batch), "--per_device_eval_batch_size", "2",
            "--max_steps", "2", "--eval_steps", "2", "--save_steps", "2",
            "--logging_steps", "1", "--generation_max_length", "8", "--wer_weight", "0.7",
            "--output_dir", str(root / "out"), "--storage_path", str(root / "hpo"),
            "--output_tag", "exp", "--random_seed", "3", "--peft", "--load_in_8bit",
            "--adalora", "--lora_rank", "4", "--lora_alpha", "8",
            "--search_schedule_mode", "small_small", "--hyperparameters",
            "learning_rate,rank", "--grace_period", "2", "--num_samples", str(samples),
            *extra]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(root: pathlib.Path, name: str, argv, ranks: int = 0, **spec):
    """The worker over `argv`: one process (ranks 0) or `ranks` ranks of a
    gloo group on this host."""
    d = root / name
    d.mkdir()
    (d / "spec.json").write_text(json.dumps({"argv": argv, **spec}))
    base = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    base.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    port = _free_port()
    procs = []
    for r in range(max(ranks, 1)):
        env = dict(base)
        if ranks:
            env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", RANK=str(r),
                       WORLD_SIZE=str(ranks), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(ranks))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(d / "spec.json"), str(d / f"rank{r}.json")],
            cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    return d, procs


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp("packing")
    folder = _write_folder(root / "folder")
    flags = ("--chips_per_trial", "1", "--max_concurrent_trials", "2")
    runs = {
        # (b) two ranks, one-rank slots, 4 trials, then a resume; its serial run
        "one_rank_slots": _start(root, "one_rank_slots",
                                 _argv(folder, root / "one_rank_slots", 2, 4, *flags),
                                 ranks=2, resume=True),
        "serial": _start(root, "serial", _argv(folder, root / "serial", 2, 4, *flags)),
        # (c), (d) four ranks, two-rank slots (1 row a rank), 3 trials, the
        # second failing on both its ranks; one process at the global batch
        # (its second trial failed too: only the others are compared)
        "two_rank_slots": _start(root, "two_rank_slots",
                                 _argv(folder, root / "two_rank_slots", 1, 3,
                                       "--chips_per_trial", "2",
                                       "--max_concurrent_trials", "2"),
                                 ranks=4, fail=["trial_0001"]),
        "global_batch": _start(root, "global_batch",
                               _argv(folder, root / "global_batch", 2, 3),
                               fail=["trial_0001"]),
    }
    procs = [p for _, ps in runs.values() for p in ps]
    try:
        logs = [p.communicate(timeout=PROC_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    out = {}
    for name, (d, ps) in runs.items():
        out[name] = [json.loads((d / f"rank{r}.json").read_text()) for r in range(len(ps))]
        exp = d / "hpo" / "exp"
        out[name + "_files"] = {f: json.loads((exp / f).read_text()) for f in (
            "experiment_state.json", "searcher_state.json", "scheduler_state.json",
            "best_result.json")}
        out[name + "_dir"] = exp
    return out


def _overlap(a, b) -> bool:
    return a["start"] < b["end"] and b["start"] < a["end"]


def test_one_rank_slots_equal_the_serial_run(packed):
    """(b) Two gloo ranks, --chips_per_trial 1 --max_concurrent_trials 2:
    two slots of one rank; every trial ran once, two at once; each trial's
    hp and result bit-equal the one-process serial run's; the searcher's
    state is the serial one's, the scheduler holds each trial's rung once;
    every rank returns the serial run's summary; the resume runs nothing
    and names the same best trial."""
    ranks, serial = packed["one_rank_slots"], packed["serial"][0]
    ran = [t for r in ranks for t in r["ran"]]
    assert sorted(t["trial"] for t in ran) == [f"trial_{i:04d}" for i in range(4)]
    assert {(t["global_rank"], t["slot"], t["rank"], t["world"]) for t in ran} == {
        (0, 0, 0, 1), (1, 1, 0, 1)}
    assert any(_overlap(a, b) for a in ranks[0]["ran"] for b in ranks[1]["ran"])
    ours = packed["one_rank_slots_files"]
    ref = packed["serial_files"]
    trials = ours["experiment_state.json"]["trials"]
    assert trials == ref["experiment_state.json"]["trials"]
    assert all(t["status"] == "completed" for t in trials.values())
    assert ours["searcher_state.json"] == ref["searcher_state.json"]
    rungs, ref_rungs = (f["scheduler_state.json"] for f in (ours, ref))
    assert {k: sorted(v) for k, v in rungs["rungs"].items()} == {
        k: sorted(v) for k, v in ref_rungs["rungs"].items()}
    assert rungs["seen"] == ref_rungs["seen"]
    assert ours["best_result.json"] == ref["best_result.json"]
    for r in ranks:
        assert r["summary"] == serial["summary"]
        assert r["resume_ran"] == [] and r["resumed"]["best_trial"] == \
            serial["summary"]["best_trial"]
    assert not list(packed["one_rank_slots_dir"].glob("*.tmp"))


def test_two_rank_slots_equal_one_process_at_the_global_batch(packed):
    """(c) Four gloo ranks, --chips_per_trial 2: two slots of two data
    ranks, 1 row a rank; each completed trial's hp equals one process's at
    the global batch of 2 and its result (eval loss, WER) is within rtol
    1e-5, and so is its step losses; both ranks of a slot ran each trial,
    the slots at once."""
    ranks = packed["two_rank_slots"]
    ran = [t for r in ranks for t in r["ran"]]
    by_trial = {}
    for t in ran:
        by_trial.setdefault(t["trial"], []).append(t)
    assert sorted(by_trial) == ["trial_0000", "trial_0001", "trial_0002"]
    for trial, runs in by_trial.items():
        assert sorted((t["rank"], t["world"]) for t in runs) == [(0, 2), (1, 2)]
        assert len({t["slot"] for t in runs}) == 1
        assert sorted(t["global_rank"] for t in runs) in ([0, 1], [2, 3])
    assert {t["slot"] for t in ran} == {0, 1}
    assert by_trial["trial_0000"][0]["slot"] != by_trial["trial_0001"][0]["slot"]
    assert any(_overlap(a, b) for a in ran for b in ran if a["slot"] != b["slot"])
    trials = packed["two_rank_slots_files"]["experiment_state.json"]["trials"]
    ref = packed["global_batch_files"]["experiment_state.json"]["trials"]
    for t in ("trial_0000", "trial_0002"):
        assert trials[t]["status"] == "completed" and trials[t]["hp"] == ref[t]["hp"]
        got, want = trials[t]["result"], ref[t]["result"]
        assert sorted(got) == sorted(want) and got["final_step"] == want["final_step"] == 2
        for k in ("eval_loss", "eval_wer", "eval_loss_wer"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"{t} {k}")
        losses = [[json.loads(line)["loss"] for line in
                   (d / t / "metrics.jsonl").read_text().splitlines() if '"loss"' in line]
                  for d in (packed["two_rank_slots_dir"], packed["global_batch_dir"])]
        assert len(losses[0]) == 2
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5, err_msg=t)
    summaries = [r["summary"] for r in ranks]
    assert all(s == summaries[0] for s in summaries)
    assert summaries[0]["best_trial"] in ("trial_0000", "trial_0002")


def test_a_trial_failing_on_its_slot_is_isolated(packed):
    """(d) trial_0001 raises on both ranks of its slot (the worker injects
    the fault): it is recorded errored with both ranks' tracebacks in its
    error.txt, and the slots go on to complete the other trials."""
    trials = packed["two_rank_slots_files"]["experiment_state.json"]["trials"]
    assert trials["trial_0001"]["status"] == "errored"
    assert trials["trial_0001"]["error"] == "injected fault in trial_0001"
    err = (packed["two_rank_slots_dir"] / "trial_0001" / "error.txt").read_text()
    assert err.count("injected fault in trial_0001") == 2
    assert [trials[t]["status"] for t in ("trial_0000", "trial_0002")] == ["completed"] * 2
    assert not (packed["two_rank_slots_dir"] / "trial_0000" / "error.txt").exists()

"""The port's training entry point end to end on the CPU, and its data path
against the JAX package.

`python -m asr_finetune_tpu_torch.cli.train --device cpu` on a tiny
synthetic audiofolder (test-nano, byte-fallback labels, batch 2): steps,
an eval with WER, checkpoints, step-exact resume; SpecAugment, host
log-mel and the parquet data modes train, --tp > 1 raises (PEFT and the
int8 base are ported:
tests/test_torch_peft_cli.py; beam-search eval and int8 cross-KV:
tests/test_torch_evaluate.py); without --device cpu the entry point raises
on a machine with no card; with --bf16 the trained weights stay fp32
masters while serving casts them. The collator, the length-grouped sampler and the WER
are held against the JAX package's on the same inputs."""
import csv
import json
import os
import wave

import numpy as np
import pytest
import torch

from asr_finetune_tpu.data import collator as JC
from asr_finetune_tpu.data import pipeline as JP
from asr_finetune_tpu.evaluation import normalize as JN
from asr_finetune_tpu.evaluation import wer as JWER
from asr_finetune_tpu.models import tokenizer as JT
from asr_finetune_tpu_torch import config as config_lib
from asr_finetune_tpu_torch import run as run_lib
from asr_finetune_tpu_torch.cli import train as train_cli
from asr_finetune_tpu_torch.data import collator as TC
from asr_finetune_tpu_torch.data import pipeline as TP
from asr_finetune_tpu_torch.evaluation import normalize as TN
from asr_finetune_tpu_torch.evaluation import wer as TWER
from asr_finetune_tpu_torch.models import tokenizer as TT
from asr_finetune_tpu_torch.training.train_step import leaves


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The CLI runs here are many small ops, which gain little from more
    intra-op threads; two keep the suite's parallel worker processes from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


TEXTS = ["Wir sind nach Hause gegangen.", "Die Schule war klein.",
         "Mein Vater hat erzählt.", "Das Dorf lag am Fluss.",
         "Später kam die Arbeit.", "Ich weiß es nicht mehr."]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("audiofolder")
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(TEXTS):
        name = f"u{i}.wav"
        sig = rng.standard_normal(int(16000 * rng.uniform(0.5, 2.0))) * 0.1
        with wave.open(str(d / name), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())
        rows.append((name, text))
    with open(d / "metadata.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "transcription"])
        w.writerows(rows)
    return str(d)


def _argv(folder, out, *extra, device=("--device", "cpu")):
    """4 train / 2 validation utterances, batch 2, eval + save every 2 steps;
    a constant lr, so a run cut at step 2 and resumed follows the same
    schedule as an uninterrupted one."""
    return ["--model_type", "test-nano", *device, "--data_mode", "folder",
            "--dataset_name", folder, "--val_split", "0.34",
            "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "2",
            "--max_steps", "2", "--eval_steps", "2", "--save_steps", "2",
            "--logging_steps", "1", "--learning_rate", "1e-3",
            "--lr_scheduler_type", "constant", "--generation_max_length", "8",
            "--wer_weight", "0.7", "--num_to_keep", "2", "--output_dir", str(out),
            "--output_tag", "run", "--random_seed", "3", *extra]


def _records(out):
    with open(os.path.join(out, "run", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ckpt(out, step):
    return torch.load(os.path.join(out, "run", "checkpoints", f"step_{step:08d}",
                                   "state.pt"), weights_only=True)


def test_train_cli_steps_evaluates_and_saves(folder, tmp_path):
    result = train_cli.main(_argv(folder, tmp_path))
    assert result["final_step"] == 2
    recs = _records(tmp_path)
    train = [r for r in recs if "grad_norm" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in train)
    (ev,) = [r for r in recs if "eval_loss_wer" in r]
    assert ev["step"] == 2 and 0.0 <= ev["eval_wer"]
    assert ev["eval_loss_wer"] == pytest.approx(0.3 * ev["eval_loss"] + 0.7 * ev["eval_wer"],
                                                rel=1e-9)
    step_dir = tmp_path / "run" / "checkpoints" / "step_00000002"
    assert sorted(os.listdir(step_dir)) == ["metrics.json", "state.pt"]
    with open(step_dir / "metrics.json") as f:
        assert json.load(f)["eval_loss_wer"] == pytest.approx(ev["eval_loss_wer"])
    saved = _ckpt(tmp_path, 2)
    assert saved["step"] == saved["opt_count"] == 2
    assert all(t.dtype == torch.float32 for t in saved["params"].values())
    assert set(saved["params"]) == set(saved["mu"]) == set(saved["nu"])
    assert os.path.exists(tmp_path / "run" / "trial_manifest.json")


def test_resume_is_step_exact(folder, tmp_path):
    """2 steps, a save, then --resume_training to 4: the same parameters and
    step losses as 4 uninterrupted steps."""
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    train_cli.main(_argv(folder, whole, "--max_steps", "4"))
    train_cli.main(_argv(folder, cut))
    train_cli.main(_argv(folder, cut, "--max_steps", "4", "--resume_training"))
    loss = {str(d): {r["step"]: r["loss"] for r in _records(d) if "grad_norm" in r}
            for d in (whole, cut)}
    assert loss[str(cut)] == loss[str(whole)]
    a, b = _ckpt(whole, 4), _ckpt(cut, 4)
    assert a["opt_count"] == b["opt_count"] == 4
    for part in ("params", "mu", "nu"):
        for k, t in a[part].items():
            assert torch.equal(t, b[part][k]), (part, k)


def test_train_cli_without_device_cpu_raises_here(folder, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(_argv(folder, tmp_path, device=()))


@pytest.fixture(scope="module")
def features(folder, tmp_path_factory):
    """The audiofolder's rows as an HDF5 file (the JAX writer) and as parquet
    feature shards materialized from it by the port."""
    from asr_finetune_tpu.data.hdf5 import write_hdf5_dataset
    from asr_finetune_tpu_torch.data.audiofolder import AudioFolderReader
    from asr_finetune_tpu_torch.data.hdf5 import Hdf5AudioReader
    from asr_finetune_tpu_torch.data.parquet import materialize_hdf5_to_parquet
    d = tmp_path_factory.mktemp("features")
    reader = AudioFolderReader([folder])
    rows = reader.read(range(len(reader)))
    write_hdf5_dataset(str(d / "data.h5"), [a for _, a, _ in rows], [t for _, _, t in rows])
    h5 = Hdf5AudioReader(str(d / "data.h5"))
    materialize_hdf5_to_parquet(h5, TT.load_tokenizer(), str(d / "pq"), n_mels=80,
                                shard_size=4)
    h5.close()
    return {"h5": str(d / "data.h5"), "pq": str(d / "pq")}


@pytest.mark.parametrize("flag", [("--spec_augment",), ("--host_logmel",),
                                  ("--tp", "2"), ("--data_mode", "parquet"),
                                  ("--data_mode", "val_parquet")])
def test_options_not_ported_raise(folder, features, tmp_path, flag):
    """The options that were still to port: each runs now. --tp 2 in one
    process raises, as JAX's create_mesh does when the devices do not
    divide into the model axis (two ranks train: tests/test_torch_tp.py).
    --spec_augment, --host_logmel and the parquet modes (parquet: train and
    validation from the shards; val_parquet: HDF5 train, parquet
    validation) each train two steps and evaluate (the offload flags run:
    tests/test_torch_parallel.py)."""
    if flag[0] == "--tp":
        with pytest.raises(ValueError, match="tensor-parallel groups of 2"):
            train_cli.main(_argv(folder, tmp_path, *flag))
        return
    data = {"parquet": ("--dataset_name", features["pq"]),
            "val_parquet": ("--dataset_name", features["h5"],
                            "--val_dataset_name", features["pq"])}.get(flag[-1], ())
    result = train_cli.main(_argv(folder, tmp_path, *flag, *data))
    assert result["final_step"] == 2
    recs = _records(tmp_path)
    assert all(np.isfinite(r["loss"]) for r in recs if "grad_norm" in r)
    (ev,) = [r for r in recs if "eval_loss_wer" in r]
    assert np.isfinite(ev["eval_loss"]) and ev["eval_wer"] >= 0.0


def test_bf16_training_keeps_fp32_masters(folder, tmp_path):
    """--bf16 is the compute dtype of training: the weights being trained
    stay fp32 (cast at use, as the JAX step does), while the serving
    build_model casts its matmul weights to bf16 once."""
    args = config_lib.parse_args(_argv(folder, tmp_path, "--bf16"))
    trainer = run_lib.setup_trial(args)
    try:
        assert trainer.step_cfg.compute_dtype == torch.bfloat16
        trained = leaves(trainer.state["params"])
        assert all(t.dtype == torch.float32 and t.requires_grad for _, t in trained)
    finally:
        trainer.metrics.close()
    served = run_lib.build_model(args).params
    assert served["encoder"]["layers"]["attn"]["q"]["w"].dtype == torch.bfloat16
    assert served["decoder"]["embed"].dtype == torch.bfloat16
    assert served["encoder"]["layers"]["ln1"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("features", ["audio", "host"])
def test_collator_matches_jax(features):
    """Raw audio, or the host float64 log-mel (--host_logmel) as "mel" and
    no "audio": bit-equal to the JAX collator's batch."""
    rng = np.random.default_rng(1)
    rows = [(i, rng.standard_normal(int(16000 * s)).astype(np.float32), t)
            for i, (s, t) in enumerate(zip((0.7, 31.0, 2.5), TEXTS[:2] + ["x" * 60]))]
    ours = TC.Collator(TT.load_tokenizer(), TC.CollatorConfig(features=features,
                                                              n_mels=80))(rows)
    ref = JC.Collator(JT.load_tokenizer(), JC.CollatorConfig(features=features,
                                                             n_mels=80))(rows)
    assert ours["labels"].shape == (3, 96)               # 60 bytes + prefix → bucket 96
    feat = "audio" if features == "audio" else "mel"
    assert sorted(ours) == sorted(ref) and feat in ours
    for k in ("decoder_input_ids", "labels", "idx", feat):
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    assert list(ours["text"]) == list(ref["text"])


@pytest.mark.parametrize("lengths", [None, np.random.default_rng(2).integers(5, 90, 37)])
def test_index_sampler_matches_jax(lengths):
    ours = TP.IndexSampler(37, 4, seed=5, lengths=lengths)
    ref = JP.IndexSampler(37, 4, seed=5, lengths=lengths)
    a, b = ours.batches_from_step(7), ref.batches_from_step(7)
    for _ in range(20):                                  # across two epochs
        np.testing.assert_array_equal(next(a), next(b))


def test_wer_and_normalize_match_jax():
    refs = ["Das ist, ein Test!", "Wir gingen nach Hause", "ÄÖÜ ß"]
    hyps = ["das ist ein test", "wir gehen nach", "äöü ss"]
    assert [TN.normalize(t) for t in refs] == [JN.normalize(t) for t in refs]
    n_r, n_h = [TN.normalize(t) for t in refs], [TN.normalize(t) for t in hyps]
    assert TWER.wer_percent(n_r, n_h) == pytest.approx(JWER.wer_percent(n_r, n_h))
    assert TWER.wer(refs, hyps) == pytest.approx(JWER.wer(refs, hyps))

"""`python -m asr_finetune_tpu_torch.cli.train --peft` end to end on the
CPU: LoRA/AdaLoRA over an int8 (or bf16) frozen base on test-nano, with and
without --int8_matmul (the W8A8 plain version and the outlier calibration),
an eval with WER, adapter-only checkpoints and step-exact resume; and
`run.build_model`'s frozen base and adapter placement."""
import csv
import json
import os
import wave

import numpy as np
import pytest
import torch

from asr_finetune_tpu_torch.cli import train as train_cli
from asr_finetune_tpu_torch.training import optim as TO


# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """As tests/test_torch_train_cli.py: the CLI runs are many small ops;
    two intra-op threads keep the parallel workers from oversubscribing."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("peft_audiofolder")
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


def _argv(folder, out, *extra):
    """test-nano, 4 train / 2 validation utterances, batch 2, AdaLoRA over
    the int8 base, eval + save every 2 steps, a constant lr."""
    return ["--model_type", "test-nano", "--device", "cpu", "--data_mode", "folder",
            "--dataset_name", folder, "--val_split", "0.34",
            "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "2",
            "--max_steps", "2", "--eval_steps", "2", "--save_steps", "2",
            "--logging_steps", "1", "--learning_rate", "1e-3",
            "--lr_scheduler_type", "constant", "--generation_max_length", "8",
            "--wer_weight", "0.7", "--num_to_keep", "2", "--output_dir", str(out),
            "--output_tag", "run", "--random_seed", "3", "--peft", "--load_in_8bit",
            "--adalora", "--lora_rank", "4", "--lora_alpha", "8", *extra]


def _ckpt(out, step):
    return torch.load(os.path.join(out, "run", "checkpoints", f"step_{step:08d}",
                                   "state.pt"), weights_only=True)


@pytest.mark.parametrize("int8_matmul", [True, False])
def test_peft_cli_trains_adapters_and_saves_them_only(folder, tmp_path, int8_matmul):
    """`cli.train --peft --load_in_8bit --adalora [--int8_matmul]`: finite
    steps, an eval, and an adapter-only checkpoint (adapters, their moments,
    sensitivity and rank masks; no base, so neither the int8 weights nor
    the K-major copies --int8_matmul builds beside them)."""
    extra = ("--int8_matmul",) if int8_matmul else ()
    result = train_cli.main(_argv(folder, tmp_path, *extra))
    assert result["final_step"] == 2
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in recs if "grad_norm" in r)
    (ev,) = [r for r in recs if "eval_loss_wer" in r]
    assert ev["eval_loss_wer"] == pytest.approx(0.3 * ev["eval_loss"] + 0.7 * ev["eval_wer"])
    saved = _ckpt(tmp_path, 2)
    assert "params" not in saved
    assert set(saved) == {"step", "opt_count", "mu", "nu", "adapters", "sensitivity",
                          "rank_mask"}
    assert set(saved["mu"]) == {k for k in saved["adapters"] if not k.endswith("scaling")}
    assert any(k.startswith("encoder/") for k in saved["adapters"])
    assert all(t.dtype == torch.float32 for t in saved["adapters"].values())
    names = [k for part in saved.values() if isinstance(part, dict) for k in part]
    assert not any("w_q8" in k for k in names)


def test_peft_cli_resume_is_step_exact(folder, tmp_path):
    """--int8_matmul: 2 steps, a save, then --resume_training to 4: the same
    adapters, moments, sensitivity, masks and step losses as 4 uninterrupted
    steps."""
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    train_cli.main(_argv(folder, whole, "--int8_matmul", "--max_steps", "4"))
    train_cli.main(_argv(folder, cut, "--int8_matmul"))
    train_cli.main(_argv(folder, cut, "--int8_matmul", "--max_steps", "4",
                         "--resume_training"))

    def losses(d):
        with open(d / "run" / "metrics.jsonl") as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f) if "grad_norm" in r}
    assert losses(cut) == losses(whole)
    a, b = _ckpt(whole, 4), _ckpt(cut, 4)
    assert a["opt_count"] == b["opt_count"] == a["step"] == 4
    for part in ("adapters", "mu", "nu", "sensitivity", "rank_mask"):
        for k, t in a[part].items():
            assert torch.equal(t, b[part][k]), (part, k)


def test_build_model_peft_freezes_the_base(folder, tmp_path):
    """build_model --peft: an int8 base (q/k/v/o/fc1/fc2 as int8 + fp32
    scales, the other leaves fp32) with --load_in_8bit, every leaf bf16
    without; adapters on encoder and decoder q/v (--lora_targets all) or
    the decoder only."""
    from asr_finetune_tpu_torch import config, run
    args = config.parse_args(_argv(folder, tmp_path))
    built = run.build_model(args, train=True)
    enc = built.params["encoder"]["layers"]
    assert enc["attn"]["q"]["w_q8"].dtype == torch.int8
    assert enc["attn"]["q"]["w_scale"].dtype == torch.float32
    assert enc["ln1"]["scale"].dtype == torch.float32 and "w" not in enc["mlp"]["fc1"]
    assert set(built.adapters) == {"encoder", "decoder"}
    assert built.lora.rank == 4 and built.lora.scaling == 2.0
    args = config.parse_args([a for a in _argv(folder, tmp_path) if a != "--load_in_8bit"]
                             + ["--lora_targets", "decoder"])
    built = run.build_model(args, train=True)
    assert set(built.adapters) == {"decoder"}
    assert all(t.dtype == torch.bfloat16 for _, t in TO.leaves(built.params))

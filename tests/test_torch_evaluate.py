"""The port's offline evaluator and its entry point against the JAX package,
and beam-search eval in the port's training entry point, on the CPU.

`asr_finetune_tpu_torch.cli.evaluate --device cpu` and the JAX
`cli.evaluate` run over one synthetic HDF5 set and one native checkpoint
written by the JAX package (test-nano, fp32): the same transcripts,
per-utterance and corpus WER, greedy and beam search; a second run resumes
from the progress file. The port's checkpoints (full and adapter-only with
an AdaLoRA rank mask) restore into the evaluated model: the step asked for,
or the best by eval_loss_wer. `cli.train --device cpu` runs its eval decode
with beams and int8 cross-KV."""
import csv
import json
import os
import wave

import jax
import numpy as np
import pytest
import torch

from asr_finetune_tpu.data.hdf5 import make_synthetic_dataset
from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import get_config
from asr_finetune_tpu_torch import config as config_lib
from asr_finetune_tpu_torch import run as run_lib
from asr_finetune_tpu_torch.cli import evaluate as torch_cli
from asr_finetune_tpu_torch.cli import train as train_cli
from asr_finetune_tpu_torch.data.collator import Collator, CollatorConfig
from asr_finetune_tpu_torch.data.hdf5 import Hdf5AudioReader
from asr_finetune_tpu_torch.evaluation import decode as TD
from asr_finetune_tpu_torch.evaluation.evaluate import EvalConfig, OfflineEvaluator
from asr_finetune_tpu_torch.training import lora as TL
from asr_finetune_tpu_torch.training.checkpoint import CheckpointManager
from asr_finetune_tpu_torch.training.optim import leaves


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Many small ops: two intra-op threads keep the suite's parallel
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """8 synthetic utterances and a JAX-written test-nano checkpoint."""
    d = tmp_path_factory.mktemp("eval")
    make_synthetic_dataset(str(d / "test.h5"), n=8, seed=3, min_sec=0.5, max_sec=1.0)
    cfg = get_config("test-nano")
    JIO.save_params(str(d / "ckpt"), JW.init_params(jax.random.PRNGKey(3), cfg), cfg)
    return d


def _argv(d, out, *extra):
    return ["--model_path", str(d / "ckpt"), "--dataset_name", str(d / "test.h5"),
            "--per_device_eval_batch_size", "4", "--generation_max_length", "12",
            "--eval_output_dir", str(out), "--target_language", "german",
            "--no-bf16", *extra]


@pytest.mark.parametrize("beams", [1, 2])
def test_cli_evaluate_matches_jax_and_resumes(data, tmp_path, beams):
    from asr_finetune_tpu.cli import evaluate as jax_cli
    extra = ("--generation_num_beams", str(beams))
    ref = jax_cli.main(_argv(data, tmp_path / "jax", *extra))
    ours = torch_cli.main(_argv(data, tmp_path / "torch", *extra, "--device", "cpu"))
    assert ours["n_utterances"] == ref["n_utterances"] == 8
    assert ours["results"] == ref["results"]
    assert ours["wer"] == pytest.approx(ref["wer"])
    on_disk = json.loads((tmp_path / "torch" / "eval_final.json").read_text())
    assert on_disk["results"] == ref["results"]
    # resume: the progress file says every batch is done → the same result
    again = torch_cli.main(_argv(data, tmp_path / "torch", *extra, "--device", "cpu"))
    assert again["results"] == ours["results"]


def _evaluator(built, out, params=None, adapters=None, **kw):
    cfg = EvalConfig(max_length=12, batch_size=2, output_dir=str(out),
                     compute_dtype=torch.float32, **kw)
    return OfflineEvaluator(built.cfg, built.params if params is None else params,
                            built.tokenizer, cfg, adapters)


def _batches(data, built, size=2):
    reader = Hdf5AudioReader(str(data / "test.h5"))
    col = Collator(built.tokenizer, CollatorConfig(n_mels=built.cfg.num_mel_bins))
    for i in range(0, 8, size):
        yield col(reader.read(list(range(i, i + size))))


def test_offline_evaluator_resume_mid_stream_matches_jax(data, tmp_path):
    """Kill and resume: a run over the first 2 batches, then one over all 4
    skips the 2 recorded (checkpoint_every 1: eval_step_N.json each batch);
    the transcripts equal the JAX evaluator's over the same batches."""
    import jax.numpy as jnp
    from asr_finetune_tpu import config as jconfig
    from asr_finetune_tpu import run as jrun
    from asr_finetune_tpu.data.collator import Collator as JCollator
    from asr_finetune_tpu.data.collator import CollatorConfig as JCollatorConfig
    from asr_finetune_tpu.data.hdf5 import Hdf5AudioReader as JReader
    from asr_finetune_tpu.evaluation import evaluate as JE

    args = config_lib.parse_args(["--model_path", str(data / "ckpt"), "--device", "cpu",
                                  "--no-bf16"])
    built = run_lib.build_model(args)
    it = _batches(data, built)
    _evaluator(built, tmp_path / "ev", checkpoint_every=1, num_beams=2).run(
        [next(it), next(it)])
    ckpt = json.loads((tmp_path / "ev" / "eval_checkpoint.json").read_text())
    assert ckpt["current_count"] == 2 and len(ckpt["results"]) == 4
    assert (tmp_path / "ev" / "eval_step_2.json").exists()
    final = _evaluator(built, tmp_path / "ev", checkpoint_every=1, num_beams=2).run(
        _batches(data, built))
    assert final["n_utterances"] == 8            # 4 before + 4 new, no duplicates

    jargs = jconfig.parse_args(["--model_path", str(data / "ckpt")])
    jbuilt = jrun.build_model(jargs)
    jreader = JReader(str(data / "test.h5"))
    jcol = JCollator(jbuilt.tokenizer, JCollatorConfig(features="audio"))
    jev = JE.OfflineEvaluator(jbuilt.cfg, jbuilt.params, jbuilt.tokenizer, JE.EvalConfig(
        max_length=12, batch_size=2, num_beams=2, output_dir=str(tmp_path / "jev"),
        compute_dtype=jnp.float32))
    ref = jev.run(jcol(jreader.read([i, i + 1])) for i in range(0, 8, 2))
    assert final["results"] == ref["results"]


def _opt_state():
    return {"count": 0, "names": [], "mu": [], "nu": []}


def _predictions(data, built, out, params=None, adapters=None):
    return [r["predicted"] for r in _evaluator(built, out, params, adapters).run(
        _batches(data, built))["results"]]


def test_cli_evaluate_restores_full_checkpoints(data, tmp_path):
    """Two full checkpoints of perturbed parameters: --checkpoint_step picks
    its step, --use_best_checkpoint the lower eval_loss_wer, none the
    latest; each run's transcripts are those of the restored parameters."""
    args = config_lib.parse_args(["--model_path", str(data / "ckpt"), "--device", "cpu",
                                  "--no-bf16"])
    built = run_lib.build_model(args)
    g = torch.Generator().manual_seed(0)
    trees = {2: _perturbed(built.params, g, 0.05), 4: _perturbed(built.params, g, 0.5)}
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3, metric="eval_loss_wer")
    for step, score in ((2, 5.0), (4, 9.0)):
        mgr.save(step, {"step": step, "params": trees[step], "opt_state": _opt_state()},
                 {"eval_loss_wer": score})
    want = {s: _predictions(data, built, tmp_path / f"direct{s}", trees[s]) for s in (2, 4)}
    assert want[2] != want[4]
    for flags, step in ((("--checkpoint_step", "4"), 4), (("--use_best_checkpoint",), 2),
                        ((), 4)):
        out = tmp_path / f"cli{'_'.join(flags)}"
        final = torch_cli.main(_argv(data, out, "--device", "cpu", "--checkpoint_dir",
                                     str(tmp_path / "ck"), *flags))
        got = [r["predicted"] for r in final["results"]]
        assert got == want[step], flags


def _perturbed(params, g, scale):
    """A copy of params with every float leaf moved by N(0, scale) noise."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, g, scale)
        else:
            out[k] = v + scale * torch.randn(v.shape, generator=g) \
                if v.is_floating_point() else v.clone()
    return out


def test_cli_evaluate_restores_adalora_adapters(data, tmp_path):
    """An adapter-only checkpoint over the int8 base: the adapters restore
    into the freshly drawn ones and the saved AdaLoRA rank mask (half the
    ranks pruned) applies to them; the transcripts are those of the base
    with the masked adapters."""
    peft = ("--peft", "--adalora", "--load_in_8bit", "--lora_rank", "4", "--lora_alpha", "8")
    args = config_lib.parse_args(["--model_path", str(data / "ckpt"), "--device", "cpu",
                                  "--no-bf16", *peft])
    built = run_lib.build_model(args)
    g = torch.Generator().manual_seed(1)
    adapters = _perturbed(built.adapters, g, 0.3)
    mask = TL.init_rank_mask(adapters)
    for _, m in leaves(mask):
        m[..., ::2] = 0.0
    mgr = CheckpointManager(str(tmp_path / "ck"), adapter_only=True)
    mgr.save(3, {"step": 3, "params": built.params, "adapters": adapters,
                 "rank_mask": mask, "opt_state": _opt_state()})
    want = _predictions(data, built, tmp_path / "direct", built.params,
                        TL.apply_rank_mask(adapters, mask))
    unmasked = _predictions(data, built, tmp_path / "unmasked", built.params, adapters)
    assert want != unmasked
    final = torch_cli.main(_argv(data, tmp_path / "cli", "--device", "cpu", *peft,
                                 "--checkpoint_dir", str(tmp_path / "ck")))
    assert [r["predicted"] for r in final["results"]] == want


TEXTS = ["Wir sind nach Hause gegangen.", "Die Schule war klein.",
         "Mein Vater hat erzählt.", "Das Dorf lag am Fluss.",
         "Später kam die Arbeit.", "Ich weiß es nicht mehr."]


def test_train_cli_eval_decodes_with_beams_and_int8_kv(tmp_path, monkeypatch):
    """cli.train --device cpu with --generation_num_beams 2 --decode_kv_int8:
    the eval's WER decode is beam search over int8 cross-KV, and its record
    lands in metrics.jsonl."""
    rng = np.random.default_rng(0)
    folder = tmp_path / "af"
    folder.mkdir()
    with open(folder / "metadata.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "transcription"])
        for i, text in enumerate(TEXTS):
            sig = rng.standard_normal(int(16000 * rng.uniform(0.5, 2.0))) * 0.1
            with wave.open(str(folder / f"u{i}.wav"), "wb") as wf:
                wf.setnchannels(1)
                wf.setsampwidth(2)
                wf.setframerate(16000)
                wf.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())
            w.writerow([f"u{i}.wav", text])
    calls = []
    orig = TD.beam_decode

    def beam_decode(*a, **kw):
        calls.append((a[5], kw["kv_int8"]))
        return orig(*a, **kw)

    monkeypatch.setattr(TD, "beam_decode", beam_decode)
    result = train_cli.main([
        "--model_type", "test-nano", "--device", "cpu", "--data_mode", "folder",
        "--dataset_name", str(folder), "--val_split", "0.34",
        "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "2",
        "--max_steps", "1", "--eval_steps", "1", "--save_steps", "1",
        "--logging_steps", "1", "--generation_max_length", "8", "--wer_weight", "0.7",
        "--output_dir", str(tmp_path / "out"), "--output_tag", "run",
        "--generation_num_beams", "2", "--decode_kv_int8"])
    assert result["final_step"] == 1 and np.isfinite(result["eval_loss_wer"])
    assert calls and all(c == (2, True) for c in calls)
    with open(os.path.join(tmp_path, "out", "run", "metrics.jsonl")) as f:
        (ev,) = [r for r in map(json.loads, f) if "eval_wer" in r]
    assert ev["eval_loss_wer"] == pytest.approx(0.3 * ev["eval_loss"] + 0.7 * ev["eval_wer"])


def test_cli_evaluate_raises_without_cuda(data, tmp_path):
    """Without --device cpu the entry point asks for the card and raises
    on a machine that has none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli.main(_argv(data, tmp_path / "ev"))

"""The port's error-type classification (classify/, cli.classify) against the
JAX package's: the alignment, the sound key and the rule-based scores on
seeded pairs, the CSV byte for byte (also after a resume from a
half-written file), the profile, compare_error_profiles' files, and the
LLM judge end to end over a tiny GPT-2 on the CPU."""
import csv
import json

import numpy as np
import pytest

from asr_finetune_tpu.classify import error_types as JE
from asr_finetune_tpu.classify import plots as JP
from asr_finetune_tpu_torch.classify import error_types as TE
from asr_finetune_tpu_torch.classify import plots as TP
from asr_finetune_tpu_torch.cli import classify as classify_cli

WORDS = ["der", "Hund", "hunt", "läuft", "leuft", "1944", "1934", "Großmutter",
         "Grossmutter", "Bahnhof", "Bahn", "hof", "Erinnerungen", "Erinnerung",
         "schön", "schon", "ähm", "und", "wir", "haben"]


def _pairs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ref = list(rng.choice(WORDS, rng.integers(1, 10)))
        hyp = list(ref)
        for _ in range(int(rng.integers(0, 4))):        # substitute, drop, insert
            op, i = int(rng.integers(3)), int(rng.integers(len(hyp) + 1))
            w = str(rng.choice(WORDS))
            if op == 0 and i < len(hyp):
                hyp[i] = w
            elif op == 1 and i < len(hyp):
                del hyp[i]
            else:
                hyp.insert(i, w)
        out.append((" ".join(ref), " ".join(hyp)))
    return out


def _eval_json(path, pairs):
    path.write_text(json.dumps({"wer": 0.0, "n_utterances": len(pairs), "results": [
        {"original": r, "predicted": h, "wer": None} for r, h in pairs]}, ensure_ascii=False))
    return str(path)


def test_taxonomy_align_and_sound_key_equal_jax():
    assert [(t.name, t.description) for t in TE.DEFAULT_ERROR_TYPES] == \
        [(t.name, t.description) for t in JE.DEFAULT_ERROR_TYPES]
    for r, h in _pairs(0, 40):
        assert TE._align(r.split(), h.split()) == JE._align(r.split(), h.split())
    for w in WORDS + ["Schachtel", "Vater", "Straße", "Kinder", "Zeit", "Stadt"]:
        assert TE._phonetic_key(w) == JE._phonetic_key(w)


def test_rule_based_scores_equal_jax():
    ours, ref = TE.RuleBasedClassifier(), JE.RuleBasedClassifier()
    for r, h in _pairs(1, 60):
        assert ours.classify(r, h) == ref.classify(r, h)
    s = ours.classify("der hund läuft", "der hunt läuft")
    assert s["substitution_phonetic"]["N"] == 1


def test_csv_and_profile_byte_equal_to_jax(tmp_path):
    ev = _eval_json(tmp_path / "eval_final.json", _pairs(2, 9))
    rows = TE.classify_eval_results(ev, str(tmp_path / "t.csv"), save_every=4)
    JE.classify_eval_results(ev, str(tmp_path / "j.csv"), save_every=4)
    assert len(rows) == 9 * len(TE.DEFAULT_ERROR_TYPES)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert TE.aggregate_error_profile(str(tmp_path / "t.csv")) == \
        JE.aggregate_error_profile(str(tmp_path / "j.csv"))


def test_resume_from_half_written_csv(tmp_path, monkeypatch):
    """A run stopped after its 4th utterance's flush resumes at the 5th: the
    CSV ends byte-equal to one uninterrupted run's, and no utterance is
    scored twice."""
    ev = _eval_json(tmp_path / "eval_final.json", _pairs(3, 10))
    full = tmp_path / "full.csv"
    TE.classify_eval_results(ev, str(full), save_every=2)
    n_types = len(TE.DEFAULT_ERROR_TYPES)
    with open(full, newline="", encoding="utf-8") as f:
        lines = f.read().splitlines(keepends=True)
    half = tmp_path / "half.csv"
    half.write_text("".join(lines[: 1 + 4 * n_types]), encoding="utf-8")
    calls = []

    class Counting(TE.RuleBasedClassifier):
        def classify(self, reference, hypothesis, error_types=TE.DEFAULT_ERROR_TYPES):
            calls.append(reference)
            return super().classify(reference, hypothesis, error_types)

    monkeypatch.setattr(TE, "RuleBasedClassifier", Counting)
    rows = TE.classify_eval_results(ev, str(half), save_every=2)
    assert len(calls) == 6 and len(rows) == 10 * n_types
    assert half.read_bytes() == full.read_bytes()


def test_cli_rule_based_needs_no_device(tmp_path, capsys):
    """Without --llm_model_path no device is resolved: the default
    --device cuda is not asked for, so it runs on a machine with no card."""
    ev = _eval_json(tmp_path / "eval_final.json", _pairs(4, 3))
    types = tmp_path / "types.csv"
    types.write_text("name,description\ndeletion,fehlt\ninsertion,dazu\n", encoding="utf-8")
    profile = classify_cli.main(["--eval_json", ev, "--output_csv", str(tmp_path / "e.csv"),
                                 "--error_types_csv", str(types)])
    assert sorted(profile) == ["deletion", "insertion"]
    assert json.loads(capsys.readouterr().out) == profile
    with open(tmp_path / "e.csv", newline="", encoding="utf-8") as f:
        assert len(list(csv.DictReader(f))) == 3 * 2


def test_compare_error_profiles_equal_jax(tmp_path):
    for name, seed in (("a", 5), ("b", 6)):
        ev = _eval_json(tmp_path / f"{name}.json", _pairs(seed, 5))
        TE.classify_eval_results(ev, str(tmp_path / f"{name}.csv"))
    csvs = [str(tmp_path / "a.csv"), str(tmp_path / "b.csv")]
    ours = TP.compare_error_profiles(csvs, ["vorher", "nachher"], str(tmp_path / "t"))
    ref = JP.compare_error_profiles(csvs, ["vorher", "nachher"], str(tmp_path / "j"))
    assert ours == ref
    for ext in (".json", ".csv"):
        assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()


@pytest.fixture(scope="module")
def tiny_judge(tmp_path_factory):
    """A tiny random GPT-2 with a character-level tokenizer (as
    tests/test_classify.py builds its judge)."""
    import torch
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import GPT2Config, GPT2LMHeadModel, PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("tiny_lm")
    vocab = {"[UNK]": 0, "[PAD]": 1, "<|end|>": 2}
    for ch in [chr(i) for i in range(32, 127)] + list("äöüÄÖÜß"):
        vocab.setdefault(ch, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
                            eos_token="<|end|>").save_pretrained(str(d))
    torch.manual_seed(0)
    GPT2LMHeadModel(GPT2Config(vocab_size=len(vocab), n_positions=1024, n_embd=32,
                               n_layer=1, n_head=2, eos_token_id=2,
                               pad_token_id=1)).save_pretrained(str(d))
    return str(d)


def test_llm_judge_cli_on_cpu(tiny_judge, tmp_path):
    """cli.classify --llm_model_path --device cpu: prompt, generation, JSON
    parse (a random model gives none: 'unparsbar'), CSV; and the
    quantized judge on the CPU."""
    ev = _eval_json(tmp_path / "eval_final.json", [("hallo welt", "hallo wald"),
                                                    ("das ist ein test", "das ist kein test")])
    types = tmp_path / "types.csv"
    types.write_text("name,description\ndeletion,fehlt\nnumber,zahl\n", encoding="utf-8")
    out = tmp_path / "judge.csv"
    profile = classify_cli.main(["--eval_json", ev, "--output_csv", str(out),
                                 "--llm_model_path", tiny_judge, "--device", "cpu",
                                 "--error_types_csv", str(types)])
    assert sorted(profile) == ["deletion", "number"]
    with open(out, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    assert [(r["idx"], r["error_type"]) for r in rows] == [
        ("0", "deletion"), ("0", "number"), ("1", "deletion"), ("1", "number")]
    q = TE.LLMClassifier(tiny_judge, max_new_tokens=4, quantize=True, device="cpu")
    s = q.classify("das ist ein test", "das ist kein test", TE.DEFAULT_ERROR_TYPES[:1])
    assert {"p", "N", "warum"} <= set(next(iter(s.values())))


@pytest.mark.parametrize("argv", [["--quantize"], ["--quantize", "--device", "cuda"]])
def test_quantize_needs_device_cpu(tmp_path, argv):
    ev = _eval_json(tmp_path / "eval_final.json", [("a b", "a c")])
    with pytest.raises(ValueError, match="--device cpu"):
        classify_cli.main(["--eval_json", ev, "--output_csv", str(tmp_path / "q.csv"),
                           "--llm_model_path", str(tmp_path / "no_model"), *argv])

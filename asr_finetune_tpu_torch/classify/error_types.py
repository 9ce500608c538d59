"""ASR error-type classification over evaluation transcripts.

A copy of asr_finetune_tpu/classify/error_types.py for the port: for each
(reference, hypothesis) pair of an eval_final.json and each error type, a
score {"p": probability, "N": count, "warum": reason}, from a deterministic
classifier over the word alignment (`RuleBasedClassifier`, no model, runs
anywhere) or from a local instruct model as judge (`LLMClassifier`, an HF
text-generation pipeline on the device it is given: the card unless asked
for the CPU). The CSV is written every `save_every` utterances and resumed
from where it stopped. The taxonomy is German oral-history ASR's; a
`name,description` CSV replaces it.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import logging
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ErrorType:
    name: str
    description: str


# the ASR error taxonomy (German oral-history focus)
DEFAULT_ERROR_TYPES: Tuple[ErrorType, ...] = (
    ErrorType("substitution_phonetic",
              "Ein Wort wurde durch ein ähnlich klingendes Wort ersetzt."),
    ErrorType("substitution_semantic",
              "Ein Wort wurde durch ein inhaltlich anderes Wort ersetzt."),
    ErrorType("deletion", "Ein oder mehrere Wörter der Referenz fehlen."),
    ErrorType("insertion", "Wörter wurden hinzugefügt, die nicht gesagt wurden."),
    ErrorType("proper_noun", "Eigennamen (Personen, Orte) wurden falsch erkannt."),
    ErrorType("number", "Zahlen oder Daten wurden falsch transkribiert."),
    ErrorType("compound", "Deutsche Komposita wurden falsch getrennt oder verbunden."),
    ErrorType("inflection", "Falsche Flexionsform (Kasus, Numerus, Tempus)."),
    ErrorType("dialect", "Dialektale oder umgangssprachliche Formen wurden normalisiert "
                         "oder falsch erkannt."),
    ErrorType("repetition_disfluency",
              "Wiederholungen oder Häsitationen wurden falsch behandelt."),
)


def load_error_types(csv_path: str) -> List[ErrorType]:
    """`name,description` CSV → error types."""
    out = []
    with open(csv_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            out.append(ErrorType(row["name"], row.get("description", "")))
    return out


def _align(ref_words: List[str], hyp_words: List[str]):
    """Levenshtein alignment → list of (op, ref_word, hyp_word)."""
    m, n = len(ref_words), len(hyp_words)
    dp = [[0] * (n + 1) for _ in range(m + 1)]
    for i in range(m + 1):
        dp[i][0] = i
    for j in range(n + 1):
        dp[0][j] = j
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            cost = 0 if ref_words[i - 1] == hyp_words[j - 1] else 1
            dp[i][j] = min(dp[i - 1][j] + 1, dp[i][j - 1] + 1,
                           dp[i - 1][j - 1] + cost)
    ops = []
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] \
                and ref_words[i - 1] == hyp_words[j - 1]:
            ops.append(("ok", ref_words[i - 1], hyp_words[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] + 1:
            ops.append(("sub", ref_words[i - 1], hyp_words[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            ops.append(("del", ref_words[i - 1], None))
            i -= 1
        else:
            ops.append(("ins", None, hyp_words[j - 1]))
            j -= 1
    return list(reversed(ops))


def _phonetic_key(w: str) -> str:
    """Crude German-aware sound key for phonetic-substitution detection."""
    w = w.lower()
    for a, b in (("sch", "s"), ("ch", "k"), ("ck", "k"), ("ph", "f"),
                 ("th", "t"), ("dt", "t"), ("ie", "i"), ("ei", "a"),
                 ("eu", "o"), ("äu", "o"), ("ä", "e"), ("ö", "o"), ("ü", "u"),
                 ("v", "f"), ("w", "f"), ("z", "s"), ("ß", "s"),
                 # German final devoicing pairs
                 ("d", "t"), ("b", "p"), ("g", "k")):
        w = w.replace(a, b)
    w = re.sub(r"(.)\1+", r"\1", w)
    return w


class RuleBasedClassifier:
    """Deterministic offline classifier from the word alignment."""

    def classify(self, reference: str, hypothesis: str,
                 error_types: Sequence[ErrorType] = DEFAULT_ERROR_TYPES
                 ) -> Dict[str, Dict]:
        ops = _align(reference.lower().split(), hypothesis.lower().split())
        counts = {t.name: 0 for t in error_types}
        reasons: Dict[str, List[str]] = {t.name: [] for t in error_types}

        def bump(name, why):
            if name in counts:
                counts[name] += 1
                reasons[name].append(why)

        for op, r, h in ops:
            if op == "del":
                bump("deletion", f"fehlt: {r!r}")
            elif op == "ins":
                bump("insertion", f"hinzugefügt: {h!r}")
            elif op == "sub":
                why = f"{r!r} → {h!r}"
                if r and h and _phonetic_key(r) == _phonetic_key(h):
                    bump("substitution_phonetic", why)
                else:
                    bump("substitution_semantic", why)
                if r and r[0].isupper():
                    bump("proper_noun", why)
                if r and any(c.isdigit() for c in r + (h or "")):
                    bump("number", why)
                if r and h and (r.replace(" ", "") == h.replace(" ", "")
                                or r in h or h in r) and len(r) > 6:
                    bump("compound", why)
                if r and h and len(r) > 3 and len(h) > 3 and r[:4] == h[:4]:
                    bump("inflection", why)

        n_err = sum(1 for op, _, _ in ops if op != "ok") or 1
        out = {}
        for t in error_types:
            n = counts.get(t.name, 0)
            out[t.name] = {"p": round(n / n_err, 3), "N": n,
                           "warum": "; ".join(reasons.get(t.name, [])[:3])}
        return out


class LLMClassifier:
    """LLM-as-judge through a local HF instruct model (German prompt).

    The pipeline runs on `device` ("cuda", the default, or "cpu"; resolved
    by device.resolve_device, so a missing card raises). quantize=True
    runs the judge's Linear layers dynamically int8-quantized
    (torch.ao.quantization.quantize_dynamic), a CPU-only form: it needs
    device "cpu" and raises otherwise."""

    def __init__(self, model_path: str, max_new_tokens: int = 128,
                 quantize: bool = False, device: str = "cuda"):
        import torch

        from ..device import resolve_device
        if quantize and torch.device(device).type != "cpu":
            raise ValueError("--quantize is CPU dynamic int8 quantization: "
                             f"run the judge with --device cpu (got {device!r})")
        dev = resolve_device(device)
        from transformers import AutoModelForCausalLM, AutoTokenizer, pipeline
        self.pipe = pipeline(
            "text-generation", device=dev,
            model=AutoModelForCausalLM.from_pretrained(model_path, local_files_only=True),
            tokenizer=AutoTokenizer.from_pretrained(model_path, local_files_only=True))
        if quantize:
            self.pipe.model = torch.ao.quantization.quantize_dynamic(
                self.pipe.model, {torch.nn.Linear}, dtype=torch.qint8)
        self.max_new_tokens = max_new_tokens

    def classify(self, reference: str, hypothesis: str,
                 error_types: Sequence[ErrorType] = DEFAULT_ERROR_TYPES
                 ) -> Dict[str, Dict]:
        out = {}
        for t in error_types:
            prompt = (
                "Du bist ein Experte für automatische Spracherkennung. "
                f"Fehlertyp: {t.name} — {t.description}\n"
                f"Referenz: {reference}\nHypothese: {hypothesis}\n"
                'Antworte NUR mit JSON: {"p": <0..1>, "N": <Anzahl>, '
                '"warum": "<kurze Begründung>"}')
            text = self.pipe(prompt, max_new_tokens=self.max_new_tokens,
                             do_sample=False)[0]["generated_text"]
            m = re.search(r"\{.*\}", text[len(prompt):], re.DOTALL)
            try:
                out[t.name] = json.loads(m.group(0)) if m else \
                    {"p": 0.0, "N": 0, "warum": "unparsbar"}
            except json.JSONDecodeError:
                out[t.name] = {"p": 0.0, "N": 0, "warum": "unparsbar"}
        return out


def classify_eval_results(eval_json_path: str, output_csv: str,
                          model_path: Optional[str] = None,
                          error_types: Sequence[ErrorType] = DEFAULT_ERROR_TYPES,
                          save_every: int = 20,
                          quantize: bool = False,
                          device: str = "cuda") -> List[Dict]:
    """Classify every (original, predicted) pair from an eval_final.json,
    with the LLM judge on `device` when model_path is given, else the rule
    classifier. The CSV is rewritten after each `save_every` utterances and
    resumed from an existing one."""
    with open(eval_json_path) as f:
        results = json.load(f)["results"]

    clf = (LLMClassifier(model_path, quantize=quantize, device=device) if model_path
           else RuleBasedClassifier())
    done = 0
    rows: List[Dict] = []
    if os.path.exists(output_csv):
        with open(output_csv, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        done = len({r["idx"] for r in rows})
        logger.info("resuming classification at row %d", done)

    fieldnames = ["idx", "original", "predicted", "error_type", "p", "N", "warum"]

    def flush():
        with open(output_csv, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames)
            w.writeheader()
            w.writerows(rows)

    for i, r in enumerate(results):
        if i < done:
            continue
        scores = clf.classify(r["original"], r["predicted"], error_types)
        for name, s in scores.items():
            rows.append({"idx": i, "original": r["original"],
                         "predicted": r["predicted"], "error_type": name,
                         "p": s.get("p", 0.0), "N": s.get("N", 0),
                         "warum": s.get("warum", "")})
        if (i + 1) % save_every == 0:
            flush()
    flush()
    return rows


def aggregate_error_profile(csv_path: str) -> Dict[str, Dict[str, float]]:
    """Per-type aggregate (mean p, total N), the input of
    plots.compare_error_profiles."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    agg: Dict[str, Dict[str, float]] = {}
    for r in rows:
        a = agg.setdefault(r["error_type"], {"p_sum": 0.0, "N": 0.0, "rows": 0.0})
        a["p_sum"] += float(r["p"])
        a["N"] += float(r["N"])
        a["rows"] += 1
    return {k: {"mean_p": v["p_sum"] / max(v["rows"], 1), "total_N": v["N"]}
            for k, v in agg.items()}

#!/usr/bin/env python3
"""Host time per batch of the port's offline evaluator on one CUDA card.

    python3 tools/bench_eval_host.py [--root TREE] [--model small] [--batches 8]
        [--batch_size 8] [--max_length 48] [--beams 4]

Imports asr_finetune_tpu_torch from TREE (default: this checkout), so two
trees, for example a parent commit unpacked by `git archive` into a
git-ignored directory and this one, can be read in turns, one process each,
on the same card. It drives evaluation/evaluate.OfflineEvaluator (what
cli.evaluate runs) over `--batches` batches of `--batch_size` seeded
utterances (noise of 4-28 s, German-looking references), each collated by
the tree's data/collator.Collator when the evaluator asks for it, as
cli.evaluate's pipeline hands batches over; the model is random-init at the
published widths of --model, bf16, beam --beams, greedy at 1. For each
batch it reads the wall time from the start of one decode call to the
start of the next, the decode (the call, with the card synchronized at its
end), and the host time, the rest of the batch: collating, the mel's
upload and launch, detokenizing, normalizing, the per-utterance WER and
the progress record. Of the host time it also reads the per-utterance WER
calls alone (evaluation/wer.wer_percent over one pair). The first batch
(kernel loads, first launches) is left out of the medians. One JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

WORDS = ("und", "der", "die", "wir", "haben", "damals", "Großmutter", "Krieg",
         "Schule", "über", "Flüchtlinge", "Erinnerung", "Dorf", "Vater", "Mutter",
         "wurde", "nach", "Hause", "gekommen", "Jahre", "später", "Arbeit",
         "Fabrik", "mussten", "zurück", "Straße", "Kinder", "Brücke", "Bahnhof")


def utterances(n: int, seed: int = 0):
    """(idx, 16 kHz noise of 4-28 s, a reference of 8-30 words) rows."""
    rng = np.random.default_rng(seed)
    return [(i, (0.1 * rng.standard_normal(int(rng.integers(4 * 16000, 28 * 16000))))
             .astype(np.float32),
             " ".join(WORDS[int(k)] for k in rng.integers(len(WORDS),
                                                         size=int(rng.integers(8, 31)))))
            for i in range(n)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--model", default="small")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_length", type=int, default=48)
    ap.add_argument("--beams", type=int, default=4)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("bench_eval_host: no CUDA device", file=sys.stderr)
        return 2
    from asr_finetune_tpu_torch import config as config_lib
    from asr_finetune_tpu_torch import run as run_lib
    from asr_finetune_tpu_torch.data.collator import Collator, CollatorConfig
    from asr_finetune_tpu_torch.evaluation import wer as wer_lib
    from asr_finetune_tpu_torch.evaluation.evaluate import EvalConfig, OfflineEvaluator
    assert pathlib.Path(wer_lib.__file__).resolve().is_relative_to(root), wer_lib.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout

    built = run_lib.build_model(config_lib.parse_args(
        ["--model_type", args.model, "--bf16", "--device", "cuda"]))
    col = Collator(built.tokenizer, CollatorConfig(n_mels=built.cfg.num_mel_bins))
    rows = utterances(args.batches * args.batch_size)
    B = args.batch_size

    def batches():
        for i in range(args.batches):
            yield col(rows[i * B:(i + 1) * B])

    starts, decode_s, wer_s = [], [], []
    real_wer = wer_lib.wer_percent

    def timed_wer(refs, hyps):
        refs, hyps = list(refs), list(hyps)
        t0 = time.perf_counter()
        try:
            return real_wer(refs, hyps)
        finally:
            if len(refs) == 1:     # a per-utterance call of the loop
                wer_s[-1] += time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        ev = OfflineEvaluator(built.cfg, built.params, built.tokenizer,
                              EvalConfig(language="german", max_length=args.max_length,
                                         num_beams=args.beams, batch_size=B,
                                         output_dir=f"{tmp}/eval",
                                         compute_dtype=torch.bfloat16))
        real_decode = ev._decode

        def timed_decode(*a, **k):
            starts.append(time.perf_counter())
            wer_s.append(0.0)
            out = real_decode(*a, **k)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - starts[-1])
            return out

        ev._decode = timed_decode
        wer_lib.wer_percent = timed_wer
        try:
            t_end0 = time.perf_counter()
            final = ev.run(batches())
            t_end = time.perf_counter()
        finally:
            wer_lib.wer_percent = real_wer
    # the last batch's wall time ends where the evaluator's loop ends: the
    # corpus WER and eval_final.json come after it, so take the batches up
    # to the last start, and the last one only for its decode
    walls = np.diff(starts)
    host = walls - np.asarray(decode_s[:-1])
    keep = slice(1, None)   # the first batch loads kernels
    ms = lambda x: 1e3 * float(np.median(np.asarray(x)[keep]))   # noqa: E731
    print(json.dumps({
        "root": str(root), "card": card.strip(), "model": args.model, "batch_size": B,
        "batches": args.batches, "beams": args.beams, "max_length": args.max_length,
        "n_utterances": final["n_utterances"], "wer": final["wer"],
        "empty_predictions": sum(1 for r in final["results"] if not r["predicted"].split()),
        "batch_ms": ms(walls), "decode_ms": ms(decode_s[:-1]), "host_ms": ms(host),
        "utt_wer_ms": ms(wer_s[:-1]), "host_ms_each": [1e3 * float(h) for h in host],
        "run_s": t_end - t_end0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

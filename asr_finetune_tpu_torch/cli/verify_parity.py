"""Real-checkpoint parity gauntlet of the port against Hugging Face Whisper.

`python -m asr_finetune_tpu_torch.cli.verify_parity --hf_dir <whisper ckpt dir>
    [--device cuda|cpu] [--rows 2] [--max_length 48] [--beams 4] [--skip_f64]`

Counterpart of asr_finetune_tpu/cli/verify_parity.py: the same six stages,
names, tolerances, [PASS]/[FAIL] lines and final JSON line, run by the
port's stack against the SAME checkpoint loaded by transformers:
1. convert      — HF dir → the port's params (models/convert_hf), leaf count
                  and a finite fp32 forward on --device
2. f64_logits   — the port's forward in float64 on the CPU against HF in
                  double, max |Δ| relative to max |HF| below 1e-10 (in this
                  process: float64 needs no process-wide flag in PyTorch)
3. frontend     — ops/logmel.log_mel_np against the checkpoint's
                  WhisperFeatureExtractor on the same audio, below 2e-3
4. greedy       — token-stream parity against HF `generate(num_beams=1)` with
                  the dir's generation_config (suppress and begin_suppress
                  lists), language/task prompt, no timestamps
5. beam         — the same against `generate(num_beams=K)`
6. wer_smoke    — the WER between both stacks' greedy transcripts is 0 (where
                  HF's hold no word the WER is undefined: ValueError, as in
                  JAX)

The port decodes in fp32 on --device (on the card: the fused decoder
kernels); HF runs on the CPU. Exit status 0 iff every stage passes; a
failing stage prints FAIL with its diff and the gauntlet goes on. Needs
transformers, which is imported only here: without it `main` raises
ImportError naming it.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch


def _require_transformers():
    try:
        import transformers
    except ImportError as e:
        raise ImportError("cli.verify_parity needs transformers (the Hugging Face "
                          f"reference it holds the port to), which this machine "
                          f"does not have ({e})") from e
    return transformers


def _f64_logits(hf_dir: str, params, cfg, rows: int) -> dict:
    """max |Δ| and max |Δ| / max |HF| of the port's float64 forward on the
    CPU (params: the converted checkpoint, widened) against HF's in double,
    on seeded mel and tokens."""
    from transformers import WhisperForConditionalGeneration

    from ..models import whisper as W
    from ..models.native_io import params_from_numpy, params_to_numpy

    params = params_from_numpy(params_to_numpy(params), "cpu", torch.float64)
    m = WhisperForConditionalGeneration.from_pretrained(hf_dir).double().eval()
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((rows, 2 * cfg.max_source_positions, cfg.num_mel_bins))
    toks = rng.integers(0, max(cfg.vocab_size - 2000, 2), (rows, 8))
    with torch.no_grad():
        hf = m(input_features=torch.tensor(mel).transpose(1, 2),
               decoder_input_ids=torch.tensor(toks)).logits.numpy()
        ours = W.forward(params, torch.tensor(mel), torch.tensor(toks), cfg,
                         compute_dtype=torch.float64).numpy()
    denom = max(np.abs(hf).max(), 1e-30)
    return {"max_abs": float(np.abs(ours - hf).max()),
            "max_rel": float(np.abs(ours - hf).max() / denom)}


def _synth_audio(n: int, seconds: float = 4.0, sr: int = 16000) -> np.ndarray:
    """Deterministic band-limited pseudo-speech (tones + noise bursts) —
    enough signal structure that greedy/beam decodes produce non-trivial
    token streams even though the content is not real speech."""
    rng = np.random.default_rng(7)
    t = np.arange(int(seconds * sr)) / sr
    out = []
    for i in range(n):
        f0 = 90.0 + 40.0 * i
        x = np.zeros_like(t)
        for h in range(1, 6):
            x += np.sin(2 * np.pi * f0 * h * t) / h
        env = 0.5 * (1 + np.sin(2 * np.pi * (2.0 + 0.5 * i) * t))
        x = x * env + 0.02 * rng.standard_normal(t.shape)
        out.append((0.3 * x / np.abs(x).max()).astype(np.float32))
    return np.stack(out)


def _hf_generate(m, feats, prompt: List[int], max_length: int,
                 beams: int) -> np.ndarray:
    with torch.no_grad():
        return m.generate(
            input_features=torch.tensor(feats),
            decoder_input_ids=torch.tensor(
                [prompt] * feats.shape[0]),
            max_length=max_length, do_sample=False, num_beams=beams,
            length_penalty=1.0,
        ).numpy()


def _token_parity(ours_full: np.ndarray, hf_cont: np.ndarray,
                  n_forced: int, eot: int) -> dict:
    """Compare continuations up to each row's first eot.

    ours_full includes the forced prompt; hf_cont does NOT (transformers'
    whisper generate returns only the continuation when the prompt rides
    in via decoder_input_ids)."""
    rows, agree, first_div = 0, 0, []
    for b in range(ours_full.shape[0]):
        o = ours_full[b][n_forced:]
        h = hf_cont[b]
        n = min(len(o), len(h))
        o, h = o[:n], h[:n]
        stop = n
        for i in range(n):
            if h[i] == eot:
                stop = i + 1
                break
        rows += 1
        if np.array_equal(o[:stop], h[:stop]):
            agree += 1
        else:
            div = int(np.argmax(o[:stop] != h[:stop]))
            first_div.append({"row": b, "pos": div,
                              "ours": int(o[div]), "hf": int(h[div])})
    return {"rows": rows, "agree": agree, "diverged": first_div[:4]}


def _hf_top2_gap(m, feats, prompt: List[int], hf_cont: np.ndarray, pos: int,
                 suppress: List[int]) -> float:
    """HF's gap between its two best logits where a row first diverged:
    the teacher-forced forward over the prompt and HF's own tokens before
    `pos`, the suppressed ids left out. A near-zero gap is a near-tie that
    fp32 sums in another order may flip."""
    toks = torch.tensor([list(prompt) + [int(t) for t in hf_cont[:pos]]])
    with torch.no_grad():
        logits = m(input_features=torch.tensor(feats[None]),
                   decoder_input_ids=toks).logits[0, -1].double()
    logits[suppress] = -float("inf")
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hf_dir", required=True,
                   help="HF Whisper checkpoint directory (config.json + "
                        "weights + tokenizer/preprocessor files)")
    p.add_argument("--rows", type=int, default=2,
                   help="utterances per stage (CPU HF forward is slow)")
    p.add_argument("--max_length", type=int, default=48)
    p.add_argument("--beams", type=int, default=4)
    p.add_argument("--language", default="de")
    p.add_argument("--task", default="transcribe")
    p.add_argument("--skip_f64", action="store_true",
                   help="skip the (slow) float64 logit stage")
    p.add_argument("--device", default="cuda",
                   help="where the port's forward and decodes run: cuda (default) or cpu")
    a = p.parse_args(argv)

    _require_transformers()
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    from transformers import WhisperForConditionalGeneration

    from ..device import resolve_device
    from ..evaluation import decode as D
    from ..evaluation.wer import wer as wer_fn
    from ..models import whisper as W
    from ..models.convert_hf import load_pretrained
    from ..models.tokenizer import load_tokenizer
    from ..ops import logmel
    from ..training.optim import leaves

    dev = resolve_device(a.device)
    results = {}

    def record(stage: str, ok: bool, detail) -> None:
        results[stage] = {"ok": bool(ok), "detail": detail}
        print(f"[{'PASS' if ok else 'FAIL'}] {stage}: {detail}", flush=True)

    # 1. convert ------------------------------------------------------------
    params, cfg = load_pretrained(a.hf_dir, dev)
    tokenizer = load_tokenizer(a.hf_dir, cfg.vocab_size)
    mel0 = torch.zeros((1, 2 * cfg.max_source_positions, cfg.num_mel_bins), device=dev)
    with torch.no_grad():
        logits = W.forward(params, mel0, torch.zeros((1, 4), dtype=torch.long, device=dev),
                           cfg, compute_dtype=torch.float32)
    record("convert", bool(torch.isfinite(logits).all()),
           f"{len(leaves(params))} leaves, finite forward")

    # 2. f64 logits ----------------------------------------------------------
    if a.skip_f64:
        record("f64_logits", True, "skipped (--skip_f64)")
    else:
        r = _f64_logits(a.hf_dir, params, cfg, a.rows)
        record("f64_logits", r["max_rel"] < 1e-10,
               f"max |Δ| {r['max_abs']:.3e} (rel {r['max_rel']:.3e}); "
               "tol rel 1e-10")

    # shared decode inputs ---------------------------------------------------
    audio = _synth_audio(a.rows)
    mel_ours = np.stack([
        np.asarray(logmel.log_mel_np(logmel.pad_or_trim(audio[i]),
                                     n_mels=cfg.num_mel_bins))
        for i in range(a.rows)]).astype(np.float32)

    # 3. frontend ------------------------------------------------------------
    try:
        from transformers import WhisperFeatureExtractor
        fe = WhisperFeatureExtractor.from_pretrained(a.hf_dir)
        hf_feats = fe(list(audio), sampling_rate=16000,
                      return_tensors="np").input_features  # (B, mel, T)
        diff = float(np.abs(hf_feats.transpose(0, 2, 1) - mel_ours).max())
        record("frontend", diff < 2e-3,
               f"max |Δ log-mel| {diff:.2e} (tol 2e-3)")
        feats_for_hf = hf_feats
    except Exception as e:  # noqa: BLE001 — preprocessor files may be absent
        record("frontend", False, f"{type(e).__name__}: {e}")
        feats_for_hf = mel_ours.transpose(0, 2, 1)

    # 4./5. greedy + beam ----------------------------------------------------
    m = WhisperForConditionalGeneration.from_pretrained(a.hf_dir).eval()
    gen = m.generation_config
    suppress = list(gen.suppress_tokens or [])
    begin_suppress = list(gen.begin_suppress_tokens or [])
    forced = tokenizer.prefix_tokens(a.language, a.task,
                                     predict_timestamps=False)
    if any(t >= cfg.vocab_size for t in forced):
        # checkpoint dir without tokenizer files (e.g. a random-init
        # smoke checkpoint): the byte-fallback special ids exceed the
        # model vocab — prompt with the config's start token instead;
        # both stacks still receive the identical prompt
        forced = [min(cfg.sot_token_id, cfg.vocab_size - 1)]
    mel_t = torch.from_numpy(mel_ours).to(dev)

    texts = {}
    for stage, beams in (("greedy", 1), ("beam", a.beams)):
        fn = D.make_decode_fn(
            cfg, forced, a.max_length, beams,
            suppress_tokens=suppress, begin_suppress_tokens=begin_suppress,
            compute_dtype=torch.float32)
        with torch.no_grad():
            ours_tok, _ = fn(params, mel_t)
        ours_tok = ours_tok.cpu().numpy()
        hf_tok = _hf_generate(m, feats_for_hf, forced, a.max_length, beams)
        par = _token_parity(ours_tok, hf_tok, len(forced), cfg.eos_token_id)
        for d in par["diverged"]:
            d["hf_top2_gap"] = _hf_top2_gap(m, feats_for_hf[d["row"]], forced,
                                            hf_tok[d["row"]], d["pos"], suppress)
        record(stage, par["agree"] == par["rows"],
               f"{par['agree']}/{par['rows']} rows token-identical"
               + (f"; first divergences {par['diverged']}"
                  if par["diverged"] else ""))
        texts[stage] = (tokenizer.batch_decode(ours_tok[:, len(forced):]),
                        tokenizer.batch_decode(hf_tok))

    # 6. wer smoke -----------------------------------------------------------
    ours_txt, hf_txt = texts["greedy"]
    w = wer_fn(hf_txt, ours_txt)
    record("wer_smoke", w == 0.0,
           f"WER(ours vs HF transcripts) = {w:.4f} over {a.rows} utts")

    n_fail = sum(0 if r["ok"] else 1 for r in results.values())
    print(json.dumps({"stages": results, "failed": n_fail}))
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

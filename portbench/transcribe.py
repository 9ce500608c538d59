"""Serving cells: the port's offline evaluator (the path of cli.evaluate) fed
batches until the window's time is up.

Set-up builds the model as cli.evaluate does (run.build_model, serving:
the weights cast once to bf16), with the benchmark's weights (from the
configuration's family module, families.py) in the place of the port's
random init, writes the seed's utterances as an audiofolder, and warms up
on one batch through an evaluator of its own. The window's evaluator reads
its batches through the port's audiofolder reader and collator, as
cli.evaluate reads its test set; the harness keeps the tokens each decode
call returns, which the check reads after the window.
"""
from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Any, Dict, List

import numpy as np

from . import families
from . import harness as H
from . import traffic as TR


class Window:
    """What a per-layer reader of a serving cell reads."""
    kind = "transcribe"

    def __init__(self, family, n, batch):
        self.family = family          # the configuration's family module
        self.n, self.batch = n, batch
        self.spans = H.Spans()
        self.batches = 0
        self.window_s = 0.0
        self.trace = None
        self.calls = None
        self.positions: List[int] = []        # decode positions of each traced batch
        self.positions_window: List[int] = []  # and of each batch of the window
        self.traced_batches = 0
        self.host = H.HostMeter()     # the host over the (untraced) window


def positions_run(tokens: np.ndarray, n_forced: int, eot: int) -> int:
    """Decode steps the greedy loop ran for a batch: until every row has
    emitted eot after the prefix, at most max_length - 1."""
    B, T = tokens.shape
    last = 0
    for r in range(B):
        hits = np.nonzero(tokens[r, n_forced:] == eot)[0]
        last = max(last, n_forced + int(hits[0]) if hits.size else T)
    return min(T - 1, last)


def run(cell, seed: int, seconds: float, trace: bool, device, ph: H.Phases,
        out_dir: str, faults=()) -> Dict[str, Any]:
    """One run, as run.py describes it; the data pool lives in a temporary
    directory under TMPDIR for the run's length."""
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        return _run(cell, seed, seconds, trace, device, ph, out_dir, faults, tmp)


def _run(cell, seed, seconds, trace, device, ph, out_dir, faults, tmp) -> Dict[str, Any]:
    with ph("import"):
        family = families.load(cell["config"])
        import torch
        from asr_finetune_tpu_torch import config as PC
        from asr_finetune_tpu_torch import run as PR
        from asr_finetune_tpu_torch.data.audiofolder import AudioFolderReader
        from asr_finetune_tpu_torch.data.collator import Collator, CollatorConfig
        from asr_finetune_tpu_torch.evaluation.evaluate import EvalConfig, OfflineEvaluator
    cuda = device.type == "cuda"
    with ph("kernels"):
        if cuda:
            from asr_finetune_tpu_torch.ops import _build
            from asr_finetune_tpu_torch.utils import native_ext
            _build.build_all()
            native_ext.load()
    cfg, tr = cell["config"], cell["traffic"]
    s = tr["serve"]
    n = family.dims(cfg)
    B, max_len = tr["batch"], s["max_length"]
    with ph("weights"):
        weights = family.make_weights(cfg, seed, device, tr.get("weights"))
    with ph("data pool"):
        pool = TR.make_pool(tr, seed, tr["pool"])
        folder = pool.write(os.path.join(tmp, "test"))
    opts = list(s.get("options", []))
    with ph("build"):
        args = PC.parse_args(["--device", str(device), "--model_type", cfg["model_type"],
                              "--random_seed", str(seed), "--per_device_eval_batch_size",
                              str(B), "--generation_max_length", str(max_len)] + opts)
        with family.injected(weights, None):
            built = PR.build_model(args)
        del weights
        reader = AudioFolderReader([folder])
        collator = Collator(built.tokenizer, CollatorConfig(
            n_mels=built.cfg.num_mel_bins, language=args.target_language, task=args.task))

        def evaluator(name):
            ecfg = EvalConfig(language=args.target_language, task=args.task,
                              max_length=max_len, num_beams=args.generation_num_beams,
                              suppress_tokens=built.suppress_tokens,
                              begin_suppress_tokens=built.begin_suppress_tokens,
                              decode_kv_int8=args.decode_kv_int8,
                              decode_w_int8=args.decode_w_int8, batch_size=B,
                              output_dir=os.path.join(tmp, name),
                              compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
            return OfflineEvaluator(built.cfg, built.params, built.tokenizer, ecfg,
                                    built.adapters)

    order = np.random.default_rng([seed, 7]).permutation(len(pool))
    fed: List[List[int]] = []

    def rows_of(i: int) -> List[int]:
        return [int(order[(i * B + j) % len(pool)]) for j in range(B)]

    def feed(count=None, length=None, spans=None, t0=None):
        """Batches as cli.evaluate's generator makes them: the reader's
        rows, the collator; stops after `count`, or once `length` s have
        passed since t0 at a batch boundary."""
        i = 0
        last = time.perf_counter()
        while True:
            now = time.perf_counter()
            if spans is not None and i:
                spans.add("batch", last, now)
            last = now
            if (count is not None and i >= count) or \
                    (length is not None and i and now - t0 >= length):
                return
            rows = rows_of(len(fed))
            fed.append(rows)
            a = time.perf_counter()
            batch = collator(reader.read(rows))
            if spans is not None:
                spans.add("read and collate", a, time.perf_counter())
            i += 1
            yield batch

    tokens: List[Any] = []

    def tapped(ev, spans=None):
        dec = ev._decode

        def decode(params, mel, adapters=None):
            a = time.perf_counter()
            out = dec(params, mel, adapters)
            if "altered_token" in faults:
                toks = out[0].clone()
                toks[:, len(family.PREFIX)] = (toks[:, len(family.PREFIX)] + 1) % n["V"]
                out = (toks, out[1])
            tokens.append(out[0])
            if spans is not None:
                spans.add("decode", a, time.perf_counter())
            return out
        ev._decode = decode
        return ev

    with ph("warm-up"):
        tapped(evaluator("warmup")).run(feed(count=1))
        if cuda:
            torch.cuda.synchronize()
    tokens.clear()
    fed.clear()

    w = Window(family, n, B)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = ph.total()
    t0 = time.perf_counter()
    ev = tapped(evaluator("window"), w.spans)
    w.host.start()
    final = ev.run(feed(length=seconds, spans=w.spans, t0=t0))
    w.host.stop()
    w.window_s = max(b for _, b in w.spans.by["batch"]) - t0
    w.batches = len(w.spans.by["batch"])
    window_tokens = [t.cpu().numpy() for t in tokens[: w.batches]]
    window_rows = fed[: w.batches]
    w.positions_window = [positions_run(t, len(family.PREFIX), family.EOT)
                          for t in window_tokens]
    if cuda:
        w.peak_bytes = torch.cuda.max_memory_allocated()
    attempted = w.batches * B
    done = len(final["results"])

    if trace and cuda:
        card = H.CardLog(os.path.join(out_dir, "card.csv"))
        w.calls, w.trace = H.Calls(), H.Trace()
        tspans = H.Spans()
        first = len(tokens)
        w.calls.install()
        card.start()
        try:
            w.trace.start(torch)
            tev = tapped(evaluator("traced"), tspans)
            tev.run(feed(length=seconds, spans=tspans, t0=time.perf_counter()))
            w.trace.stop(torch)
        finally:
            card.stop()
            w.calls.remove()
        w.trace_spans = tspans
        w.traced_batches = len(tspans.by.get("batch", []))
        w.positions = [positions_run(t.cpu().numpy(), len(family.PREFIX), family.EOT)
                       for t in tokens[first: first + w.traced_batches]]
        attempted += w.traced_batches * B
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    del ev, built, tokens
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(cell, family, seed, pool, window_tokens, window_rows, device,
                   lower="lower" in faults)
    t_ref = time.perf_counter() - t_ref
    failed = w.batches * B - done
    return {"attempted": attempted, "failed": failed, "checks": checks,
            "metrics": {"transcribe_utt_per_s": done / w.window_s, "setup_s": setup_s},
            "window": w, "memory_peak_bytes": memory_peak, "reference_s": t_ref}


def check(cell, family, seed, pool, window_tokens, window_rows, device,
          lower: bool = False) -> Dict[str, Dict]:
    """The served tokens of a seeded sample of the window's utterances, the
    longest among them, against the reference's logits; the forced prefix
    exactly. lower: the control's tokens in the served ones' place."""
    limits = cell["limits"]
    prefix, eot = family.PREFIX, family.EOT
    flat = [(b, r) for b in range(len(window_tokens)) for r in range(window_tokens[b].shape[0])]
    prefix_errors = sum(int(np.any(window_tokens[b][r, :len(prefix)] != np.asarray(prefix)))
                        for b, r in flat)

    def served(b, r):
        t = window_tokens[b][r]
        hits = np.nonzero(t[len(prefix):] == eot)[0]
        return len(t) - len(prefix) if not hits.size else int(hits[0]) + 1

    k = int(cell["traffic"]["serve"]["check_utterances"])
    longest = max(flat, key=lambda br: served(*br))
    rng = np.random.default_rng([seed, 11])
    rest = [flat[i] for i in rng.permutation(len(flat)) if flat[i] != longest][: k - 1]
    sample = [longest] + rest
    gaps = family.served_gaps(cell["config"], seed,
                              [pool.audio(window_rows[b][r]) for b, r in sample],
                              [window_tokens[b][r].tolist() for b, r in sample],
                              len(prefix), eot, device, lower=lower,
                              law=cell["traffic"].get("weights"))
    out = {"logit_gap": max(gaps), "prefix_errors": float(prefix_errors)}
    if not limits:        # readings for the limits: every number
        return {k_: {"value": v, "limit": None} for k_, v in out.items()}
    return {k_: {"value": v, "limit": limits[k_]} for k_, v in out.items() if k_ in limits}

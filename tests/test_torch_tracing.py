"""The port's spans and host-sync counter (asr_finetune_tpu_torch/utils/
profiling.py): off, a span is one shared object and nothing is recorded;
on, spans nest per thread with their thread ids, `collect` hands over and
clears, "synchronizing CUDA operation" warnings are counted under the
innermost open span and the program's file:line (simulated on the CPU with
the same text, raised from a frame in the package's directory; a thread
with no spans counts under the dispatching thread's), enable() initialises
CUDA where a card is present, and disable() puts the warnings filter and
hook back; `trace()` writes the program's ranges into its Chrome trace and
`program_counters.json` beside it. The program's own spans: one test-nano
train step (full, PEFT with AdaLoRA, two microbatches), greedy and beam
decode, and the offline evaluator's batch. The `cuda` cases run on the
card:

    python -m pytest tests/test_torch_tracing.py -m cuda -q --noconftest

(it imports no JAX)."""
import json
import os
import threading
import warnings

import pytest
import torch

import asr_finetune_tpu_torch
from asr_finetune_tpu_torch.evaluation import decode as D
from asr_finetune_tpu_torch.evaluation.evaluate import EvalConfig, OfflineEvaluator
from asr_finetune_tpu_torch.models import whisper as W
from asr_finetune_tpu_torch.models.configs import get_config
from asr_finetune_tpu_torch.models.tokenizer import load_tokenizer
from asr_finetune_tpu_torch.training import lora as L
from asr_finetune_tpu_torch.training import optim as O
from asr_finetune_tpu_torch.training import train_step as TS
from asr_finetune_tpu_torch.utils import profiling as P

PKG_DIR = os.path.dirname(os.path.abspath(asr_finetune_tpu_torch.__file__))
SITE = "asr_finetune_tpu_torch/_simulated.py"
FORCED = [257, 258, 261, 262]    # sot, <|de|>, transcribe, notimestamps (byte layout)


# what PyTorch's sync debug mode raises at a synchronizing call, from the
# frame that made the call
SYNC = P.SYNC_TEXT + " (Triggered internally at c10/cuda/CUDAFunctions.cpp:1.)"


def in_package(src: str):
    """src compiled as if it were a file of the package: the recorder takes
    its frames for the program's."""
    return compile(src, os.path.join(PKG_DIR, "_simulated.py"), "exec")


def program(src: str = "", **scope) -> dict:
    """Run src as the package's code, with its `sync()` raising the warning
    (at line 2: the site)."""
    scope.update(warn=warnings.warn, SYNC=SYNC)
    exec(in_package("def sync():\n    warn(SYNC)\n" + src), scope)
    return scope


AT = SITE + ":2"


def sync_warning():
    """The same warning from a frame outside the package."""
    warnings.warn(SYNC, UserWarning)


@pytest.fixture
def recorder():
    P.disable()
    P.collect()
    P.enable()
    try:
        yield P
    finally:
        P.disable()
        P.collect()


def names(records):
    """Span names in the order they opened."""
    return [n for n, *_ in sorted(records["spans"], key=lambda s: s[2])]


def test_off_is_one_shared_object_and_records_nothing():
    P.disable()
    P.collect()
    a, b = P.span("train.fwd"), P.span("decode.sync")
    assert a is b is P._OFF
    with a, b:
        with P.span("inner"):
            pass
    assert P.collect() == {"spans": [], "host_syncs": {}}


def test_spans_nest_with_thread_ids(recorder):
    def worker():
        with P.span("other.thread"):
            assert P._open() == ["other.thread"]

    with P.span("outer"):
        with P.span("middle"):
            with P.span("inner"):
                assert P._open() == ["outer", "middle", "inner"]
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with P.span("second"):
            pass
    assert P._open() == []
    rec = P.collect()
    by = {n: (tid, a, b) for n, tid, a, b in rec["spans"]}
    me = threading.get_ident()
    assert {n: tid == me for n, (tid, _, _) in by.items()} == {
        "outer": True, "middle": True, "inner": True, "second": True, "other.thread": False}
    assert names(rec) == ["outer", "middle", "inner", "other.thread", "second"]
    for child, parent in (("middle", "outer"), ("inner", "middle"), ("second", "outer")):
        assert by[parent][1] <= by[child][1] <= by[child][2] <= by[parent][2]
    assert by["middle"][2] <= by["second"][1]
    assert [n for n, *_ in rec["spans"]][-1] == "outer"   # in the order they closed


def test_collect_hands_over_and_clears(recorder):
    with P.span("a"):
        program("sync()")
    got = P.collect()
    assert [n for n, *_ in got["spans"]] == ["a"]
    assert got["host_syncs"] == {"a": {AT: 1}}
    assert P.collect() == {"spans": [], "host_syncs": {}}
    with P.span("b"):
        pass
    assert [n for n, *_ in P.collect()["spans"]] == ["b"]


def test_sync_warnings_counted_by_span_and_site(recorder):
    sync = program()["sync"]
    with P.span("outer"):
        for _ in range(2):
            sync()
        with P.span("inner"):
            for _ in range(3):
                sync()                     # every occurrence counts, one site
        sync_warning()                     # not the program's frame: not counted
    sync()
    with pytest.warns(RuntimeWarning, match="another warning"):
        warnings.warn("another warning", RuntimeWarning)   # passed on to the hook before
    assert P.collect()["host_syncs"] == {
        "outer": {AT: 2}, "inner": {AT: 3}, P.NO_SPAN: {AT: 1}}


def test_sync_count_keys_on_the_warning_thread(recorder):
    sync = program()["sync"]

    def worker():
        with P.span("prefetch"):
            sync()

    with P.span("train.fwd"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert P.collect()["host_syncs"] == {"prefetch": {AT: 1}}


def test_sync_on_a_thread_without_spans_counts_under_the_dispatching_span(recorder):
    """A thread that never opened a span (on the card: autograd's device
    thread, running the backward and remat's recompute) counts under the
    innermost span open on the thread that started the work."""
    sync = program()["sync"]

    def worker():
        sync()

    def run_worker():
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    with P.span("train.bwd"):
        run_worker()
        with P.span("train.adalora"):
            run_worker()
        run_worker()
    run_worker()                           # no span open anywhere
    assert P.collect()["host_syncs"] == {
        "train.bwd": {AT: 2}, "train.adalora": {AT: 1}, P.NO_SPAN: {AT: 1}}


def test_enable_initialises_cuda_to_count(monkeypatch):
    """Where a card is present, enable() before the process's first CUDA
    call initialises CUDA and sets the sync debug mode (else nothing would
    be counted and `host_syncs` would read a zero that was not measured);
    disable() puts the mode back."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "init", lambda: calls.append("init"))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda mode: calls.append(("mode", mode)))
    P.disable()
    P.collect()
    P.enable()
    try:
        assert calls == ["init", ("mode", "warn")]
    finally:
        P.disable()
    assert calls[-1] == ("mode", 0)


def test_disable_restores_filters_hook_and_stops_counting():
    P.disable()
    P.collect()
    filters, hook = list(warnings.filters), warnings.showwarning
    P.enable()
    assert warnings.filters[0][0] == "always" and warnings.showwarning is not hook
    P.enable()                                   # a second enable changes nothing
    assert len(warnings.filters) == len(filters) + 1
    P.disable()
    assert warnings.filters == filters and warnings.showwarning is hook
    P.disable()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        program("sync()")
    assert len(seen) == 1 and P.SYNC_TEXT in str(seen[0].message)
    assert P.collect() == {"spans": [], "host_syncs": {}}
    assert P.span("x") is P._OFF


def test_trace_writes_program_ranges_and_counters(tmp_path):
    x = torch.randn(32, 32)
    with P.trace(str(tmp_path / "prof")):
        with P.span("prog.outer"):
            with P.span("prog.inner"):
                (x @ x).relu_()
            program("sync()")
    assert P.span("x") is P._OFF
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    got = {e.get("name") for e in events}
    assert {"prog.outer", "prog.inner", "aten::mm"} <= got
    counters = json.loads((tmp_path / "prof" / "program_counters.json").read_text())
    assert {k: v["count"] for k, v in counters["spans"].items()} == {
        "prog.outer": 1, "prog.inner": 1}
    assert counters["host_syncs"] == {"prog.outer": {AT: 1}}
    assert counters["host_syncs_total"] == 1
    assert counters["spans"]["prog.outer"]["host_ms"] >= counters["spans"]["prog.inner"][
        "host_ms"] > 0


@pytest.mark.parametrize("how", ["enable", "trace"])
def test_record_function_ranges_only_when_asked(how, tmp_path):
    """enable() alone opens no profiler range (a range costs several times
    a span); trace() does."""
    from torch.profiler import ProfilerActivity, profile
    P.disable()
    P.collect()
    if how == "enable":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            P.enable()
            try:
                with P.span("prog.ranged"):
                    torch.ones(4).add_(1)
            finally:
                P.disable()
        ranges = {e.key for e in prof.key_averages()}
        assert [n for n, *_ in P.collect()["spans"]] == ["prog.ranged"]
    else:
        with P.trace(str(tmp_path)):
            with P.span("prog.ranged"):
                torch.ones(4).add_(1)
        (f,) = tmp_path.glob("*.pt.trace.json")
        ranges = {e.get("name") for e in json.loads(f.read_text())["traceEvents"]}
        counters = json.loads((tmp_path / "program_counters.json").read_text())
        assert list(counters["spans"]) == ["prog.ranged"]
    assert P.span("x") is P._OFF
    assert ("prog.ranged" in ranges) == (how == "trace")


# ------------------------------------------------------ the program's spans

NANO = get_config("test-nano")


@pytest.fixture(scope="module")
def nano():
    return NANO, W.init_params(NANO, seed=0)


def _batch(B=2, T=6, frames=3000, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, 255, (B, T), generator=g)
    labels = torch.cat([toks[:, 1:], torch.full((B, 1), 256)], dim=1)
    return {"mel": torch.randn(B, frames, NANO.num_mel_bins, generator=g),
            "decoder_input_ids": toks, "labels": labels}


def _fp32(params):
    return {k: _fp32(v) if isinstance(v, dict) else v.float().clone()
            for k, v in params.items()}


@pytest.mark.parametrize("mode", ["full", "peft_adalora", "full_accum2"])
def test_train_step_spans(recorder, nano, mode):
    """fwd, bwd (once a microbatch), then update; AdaLoRA's mask update
    nested in the update; nothing of the step outside them but the
    bookkeeping."""
    cfg, params = nano
    params = _fp32(params)
    opt = O.make_optimizer(1e-4, 10)
    batch = _batch()
    kw = dict(compute_dtype=torch.float32, remat=False)
    if mode == "peft_adalora":
        lcfg = L.LoraConfig(rank=4, adalora=True, target_rank=2, dropout=0.0)
        adapters = L.init_adapters(torch.Generator().manual_seed(1), cfg, lcfg)
        state = TS.make_train_state(params, opt, adapters, adalora=True)
        step = TS.make_train_step(cfg, opt, TS.TrainStepConfig(mode="peft", lora=lcfg, **kw))
    else:
        state = TS.make_train_state(params, opt)
        accum = 2 if mode == "full_accum2" else 1
        if accum > 1:
            batch = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
        step = TS.make_train_step(cfg, opt, TS.TrainStepConfig(accum_steps=accum, **kw))
    P.collect()
    m = step(state, batch)
    rec = P.collect()
    assert torch.isfinite(m["loss"])
    want = {"full": ["train.fwd", "train.bwd", "train.update"],
            "peft_adalora": ["train.fwd", "train.bwd", "train.update", "train.adalora"],
            "full_accum2": ["train.fwd", "train.bwd", "train.fwd", "train.bwd",
                            "train.update"]}[mode]
    assert names(rec) == want
    spans = sorted(rec["spans"], key=lambda s: s[2])
    for a, b in zip(spans, spans[1:]):
        if b[0] != "train.adalora":
            assert a[3] <= b[2]                       # one after another
    if mode == "peft_adalora":
        upd, ada = spans[-2], spans[-1]
        assert upd[2] <= ada[2] <= ada[3] <= upd[3]


def _decoded_positions(tokens, n_forced, eot, max_length):
    """Loop iterations of a greedy decode: to the first position after the
    prefix where every row has emitted eot, at most max_length - 1."""
    last = 0
    for row in tokens.tolist():
        ends = [i for i in range(n_forced, max_length) if row[i] == eot]
        last = max(last, ends[0] if ends else max_length - 1)
    return min(last, max_length - 1)


@pytest.mark.parametrize("ends", ["at_the_cap", "at_the_first_free_position"])
def test_greedy_decode_one_position_span_per_iteration(recorder, nano, ends):
    """One `decode.prepare`, one `decode.position` per loop iteration, each
    holding the next iteration's test (`decode.sync`) but at the cap; the
    first test is a `decode.sync` of its own."""
    cfg, params = nano
    max_length = 10
    eot = cfg.eos_token_id
    # suppressing eot never ends a row; suppressing all else ends each at once
    suppress = [eot] if ends == "at_the_cap" else [i for i in range(cfg.vocab_size)
                                                    if i != eot]
    mel = torch.randn(2, 3000, cfg.num_mel_bins, generator=torch.Generator().manual_seed(2))
    tokens, _ = D.greedy_decode(params, mel, cfg, FORCED, max_length, torch.float32,
                                suppress_tokens=suppress, fused=False)
    rec = P.collect()
    n = _decoded_positions(tokens, len(FORCED), eot, max_length)
    assert n == (max_length - 1 if ends == "at_the_cap" else len(FORCED))
    got = names(rec)
    assert got[0] == "decode.prepare" and got[1] == "decode.sync"
    assert got.count("decode.position") == n
    positions = [s for s in rec["spans"] if s[0] == "decode.position"]
    syncs = [s for s in rec["spans"] if s[0] == "decode.sync"]
    inside = [sum(p[2] <= s[2] <= s[3] <= p[3] for s in syncs) for p in positions]
    # the last position's test stops at the cap without reading the flags
    assert inside == [1] * (n - 1) + [0 if ends == "at_the_cap" else 1]
    assert len(syncs) == 1 + sum(inside)


def test_beam_decode_one_position_span_per_step(recorder, nano):
    cfg, params = nano
    mel = torch.randn(2, 3000, cfg.num_mel_bins, generator=torch.Generator().manual_seed(3))
    st = None
    for st in D.beam_states(params, mel, cfg, FORCED, 8, 2, 1.0, torch.float32,
                            fused=False):
        pass
    got = names(P.collect())
    assert got[0] == "decode.prepare" and got[1] == "decode.sync"
    assert got.count("decode.position") == st.t > 0


def test_evaluator_batch_spans(recorder, nano, tmp_path):
    cfg, params = nano
    tok = load_tokenizer(None)
    ev = OfflineEvaluator(cfg, params, tok, EvalConfig(
        max_length=8, batch_size=2, output_dir=str(tmp_path), compute_dtype=torch.float32))
    g = torch.Generator().manual_seed(4)
    batch = {"mel": torch.randn(2, 3000, cfg.num_mel_bins, generator=g).numpy(),
             "text": ["ein test", "noch einer"]}
    P.collect()
    out = ev.run([batch])
    assert out["n_utterances"] == 2
    got = [n for n in names(P.collect()) if n not in ("decode.position", "decode.sync")]
    assert got == ["eval.mel", "decode.prepare", "eval.detok", "eval.wer"]


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
def test_card_counts_an_item_and_not_launches(monkeypatch):
    """On the card: `.item()` in the program's code inside a span counts 1,
    a span of launches alone 0, and a plain greedy decode's syncs are its
    loop tests, under `decode.sync` at decode.py (plain attention: the
    kernel takes 64-dim heads, test-nano has 32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sync debug mode)")
    monkeypatch.setenv("ASR_TPU_ATTN_IMPL", "xla")
    dev = torch.device("cuda")
    x = torch.randn(256, 256, device=dev)
    torch.cuda.synchronize()
    P.disable()
    P.collect()
    P.enable()
    try:
        with P.span("item"):
            exec(in_package("v = (x @ x).sum().item()"), {"x": x})
        with P.span("launches"):
            exec(in_package("for _ in range(8):\n    y = (x @ x).relu_()"), {"x": x})
        cfg = NANO
        params = W.init_params(cfg, seed=0, device=dev)
        mel = torch.randn(2, 3000, cfg.num_mel_bins, device=dev)
        max_length = 6
        D.greedy_decode(params, mel, cfg, FORCED, max_length, torch.float32,
                        suppress_tokens=[cfg.eos_token_id], fused=False)
        rec = P.collect()
    finally:
        P.disable()
        P.collect()
    assert torch.cuda.get_sync_debug_mode() == 0
    syncs = rec["host_syncs"]
    assert syncs["item"] == {SITE + ":1": 1}
    assert "launches" not in syncs
    by_site = syncs["decode.sync"]
    assert len(by_site) == 1 and next(iter(by_site)).startswith(
        "asr_finetune_tpu_torch/evaluation/decode.py:")
    assert sum(by_site.values()) == max_length - 1


@pytest.mark.cuda
def test_card_counts_backward_syncs_under_the_span_that_started_it():
    """On the card autograd runs the backward, and with it remat's recompute,
    on its own device thread, where no span is open: a sync in the
    recomputed forward counts under `train.bwd`, the span open on the
    thread that called `.backward()`, as the first forward's counts under
    `train.fwd`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sync debug mode)")
    from torch.utils.checkpoint import checkpoint
    threads = []
    fn = program("import threading\n"
                 "def block(x):\n"
                 "    threads.append(threading.get_ident())\n"
                 "    if x.sum().item() > 1e30:\n"
                 "        x = x * 0\n"
                 "    return (x @ x).relu()\n", threads=threads)["block"]
    x = torch.randn(64, 64, device="cuda", requires_grad=True)
    torch.cuda.synchronize()
    P.disable()
    P.collect()
    P.enable()
    try:
        with P.span("train.fwd"):
            loss = checkpoint(fn, x, use_reentrant=False).sum()
        with P.span("train.bwd"):
            loss.backward()
        torch.cuda.synchronize()
        rec = P.collect()
    finally:
        P.disable()
        P.collect()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert len(threads) == 2 and threads[0] == threading.get_ident() != threads[1]
    site = SITE + ":6"
    assert rec["host_syncs"] == {"train.fwd": {site: 1}, "train.bwd": {site: 1}}
    assert x.grad is not None and torch.isfinite(x.grad).all()

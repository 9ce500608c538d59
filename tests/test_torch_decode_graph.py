"""The greedy decode's captured position (evaluation/decode.py): the
position on the card in the decoder kernels' wrappers, the rule that picks
the graph, its buffers' key and counters, and greedy tokens through it.

On the CPU the kernels' plain versions run, and a stand-in for the CUDA
graph runs the captured body at each replay, so the graph route's loop
(the position on the card, the token gather and write, the finished flags)
is held to the host loop's tokens bit for bit. The `cuda` cases run on the
card, where the graph is a real one:

    python -m pytest tests/test_torch_decode_graph.py -m cuda -q --noconftest

(it imports no JAX)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from asr_finetune_tpu_torch.evaluation import decode as D
from asr_finetune_tpu_torch.evaluation.evaluate import EvalConfig, OfflineEvaluator
from asr_finetune_tpu_torch.models import whisper as W
from asr_finetune_tpu_torch.models.configs import get_config
from asr_finetune_tpu_torch.models.tokenizer import load_tokenizer
from asr_finetune_tpu_torch.ops import decoder_fused as DF
from asr_finetune_tpu_torch.ops import quant as Q
from asr_finetune_tpu_torch.utils import profiling as P

# test-nano's byte-tokenizer ids with 64-dim heads (the fused kernels' head)
CFG = dataclasses.replace(get_config("test-nano"), d_model=128, encoder_heads=2,
                          decoder_heads=2, d_ff=512, max_source_positions=48)
FORCED = [257, 258, 261, 262]    # sot, <|de|>, transcribe, notimestamps
TS_BEGIN, NO_TS = 263, 262
MAXLEN = 24


def _params(cfg=CFG, seed=1, device="cpu"):
    """Random weights whose greedy tokens change from position to position:
    the decoder's position table drawn wide, as the benchmark's serving
    traffic draws it."""
    params = W.init_params(cfg, seed=seed, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    pos = params["decoder"]["pos"]
    pos.copy_(torch.randn(pos.shape, generator=g, device=device) * 2.0)
    return params


def _mel(B, cfg=CFG, seed=2, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((B, 2 * cfg.max_source_positions, cfg.num_mel_bins), generator=g,
                       device=device)


class Replayed:
    """The CUDA graph's stand-in: the capture records the body, which each
    replay runs."""

    def __init__(self, body, device):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture
def graph_on_cpu(monkeypatch):
    """The graph route on the CPU, its buffers and counters fresh."""
    monkeypatch.setattr(D, "uses_graph", lambda device, fused, num_beams: fused
                        and num_beams <= 1)
    monkeypatch.setattr(D, "_Captured", Replayed)
    D.release_graphs()
    D.reset_graph_counters()
    yield
    D.release_graphs()
    D.reset_graph_counters()


def _positions(tokens, n_forced, eot, max_length):
    """The loop's positions for a batch: until every row has emitted eot
    after the prefix, at most max_length - 1."""
    last = 0
    for row in tokens.tolist():
        hits = [i for i, t in enumerate(row[n_forced:]) if t == eot]
        last = max(last, n_forced + hits[0] if hits else max_length)
    return min(max_length - 1, last)


# ------------------------------------------------- the position on the card

def _layer_operands(dtype, mix, seed=0):
    """Stacked (L=3) self-attention operands of CFG's width; mix: the k
    and wo projections int8, the others float (a merged int8 base)."""
    g = torch.Generator().manual_seed(seed)
    d, L = CFG.d_model, 3

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    w = {n: rn(L, d, d, scale=d ** -0.5).to(dtype) for n in "qkvo"}
    scales = {}
    if mix:
        for n in "ko":
            q8 = Q.quantize_weight(w[n].float())
            w[n], scales[n] = q8["w_q8"], q8["w_scale"]
    b = {n: rn(L, d, scale=0.1).to(dtype) for n in "qvo"}
    ln = (1.0 + 0.1 * rn(L, d), 0.1 * rn(L, d))
    return w, scales, b, ln


@pytest.mark.parametrize("mix", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 5, 31])
def test_fused_qkv_position_tensor_equals_int(dtype, mix, pos):
    """fused_qkv with the position as a tensor writes the cache rows the int
    position writes, and the same q."""
    w, s, b, ln = _layer_operands(dtype, mix)
    B, T, layer = 3, 32, 1
    x = torch.randn((B, CFG.d_model), generator=torch.Generator().manual_seed(3)).to(dtype)
    out = {}
    for kind, p in (("int", pos), ("tensor", torch.tensor([pos]))):
        ck = torch.zeros((3, B, T, CFG.d_model), dtype=dtype)
        cv = torch.zeros_like(ck)
        q, k, v = DF.fused_qkv(x, ln[0], ln[1], w["q"], b["q"], w["k"], w["v"], b["v"],
                               wk_scale=s.get("k"), layer_idx=layer, cache_k=ck,
                               cache_v=cv, pos=p)
        out[kind] = (q, ck, cv)
        if kind == "tensor":
            assert k is None and v is None
    for a, r in zip(out["tensor"], out["int"]):
        assert torch.equal(a, r)
    assert out["int"][1][layer, :, pos].abs().sum() > 0


@pytest.mark.parametrize("mix", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 6, 31])
def test_fused_attn_position_tensor_equals_int(dtype, mix, pos):
    """Self-mode fused_attn with the position as a tensor attends the keys
    the int position attends."""
    w, s, b, _ = _layer_operands(dtype, mix)
    B, T, layer = 3, 32, 2
    g = torch.Generator().manual_seed(4)
    x = torch.randn((B, CFG.d_model), generator=g).to(dtype)
    q = torch.randn((B, CFG.d_model), generator=g) * 0.125
    ck = torch.randn((3, B, T, CFG.d_model), generator=g).to(dtype)
    cv = torch.randn((3, B, T, CFG.d_model), generator=g).to(dtype)
    ref = DF.fused_attn(x, ck, cv, w["o"], b["o"], q=q, pos=pos, wo_scale=s.get("o"),
                        layer_idx=layer)
    out = DF.fused_attn(x, ck, cv, w["o"], b["o"], q=q, pos=torch.tensor([pos]),
                        wo_scale=s.get("o"), layer_idx=layer)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("pos", [torch.tensor([1, 2]), torch.tensor([1], dtype=torch.int32),
                                 torch.tensor(1.0)])
def test_position_tensor_is_one_int64(pos):
    w, _, b, ln = _layer_operands(torch.float32, False)
    x = torch.zeros((2, CFG.d_model))
    ck = torch.zeros((3, 2, 8, CFG.d_model))
    with pytest.raises(ValueError, match="one int64"):
        DF.fused_qkv(x, ln[0], ln[1], w["q"], b["q"], w["k"], w["v"], b["v"], layer_idx=0,
                     cache_k=ck, cache_v=ck.clone(), pos=pos)
    with pytest.raises(ValueError, match="one int64"):
        DF.fused_attn(x, ck, ck, w["o"], b["o"], q=torch.zeros((2, CFG.d_model)), pos=pos,
                      layer_idx=0)


# ------------------------------------------------------------------ the rule

@pytest.mark.parametrize("device,fused,num_beams,graph", [
    ("cuda", True, 1, True), ("cuda:1", True, 1, True),
    ("cuda", False, 1, False),      # the plain step (tp > 1 takes it too)
    ("cuda", True, 4, False),       # beam search
    ("cpu", True, 1, False), ("cpu", False, 1, False), ("cpu", True, 2, False),
])
def test_graph_only_for_fused_greedy_on_cuda(device, fused, num_beams, graph):
    assert D.uses_graph(torch.device(device), fused, num_beams) is graph


def test_cpu_decode_never_captures():
    D.reset_graph_counters()
    params = _params()
    tokens, _ = D.greedy_decode(params, _mel(2), CFG, FORCED, 10, torch.float32, fused=True)
    counts = D.graph_counters()
    assert counts["captures"] == counts["replays"] == 0
    assert counts["eager_positions"] == _positions(tokens, len(FORCED), CFG.eos_token_id, 10)


# ------------------------------------------------------ the graph route's loop

VARIANTS = {
    "plain": {},
    "suppress": dict(suppress_tokens=[0, 5, 40], begin_suppress_tokens=[CFG.eos_token_id, 7]),
    "timestamps": dict(timestamp_begin=TS_BEGIN, no_timestamps_id=NO_TS),
    "int8": dict(kv_int8=True, w_int8=True),
}


@pytest.mark.parametrize("B", [3, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_graph_route_tokens_equal_host_loop(graph_on_cpu, monkeypatch, variant, dtype, B):
    kw = VARIANTS[variant]
    params, mel = _params(), _mel(B)
    args = (params, mel, CFG, FORCED, MAXLEN, dtype)
    out = D.greedy_decode(*args, fused=True, **kw)
    again = D.greedy_decode(*args, fused=True, **kw)   # the buffers of the first call
    with monkeypatch.context() as m:
        m.setattr(D, "uses_graph", lambda *a: False)
        ref = D.greedy_decode(*args, fused=True, **kw)
    for o in (out, again):
        np.testing.assert_array_equal(o[0].numpy(), ref[0].numpy())
        np.testing.assert_array_equal(o[1].numpy(), ref[1].numpy())
    assert len(set(ref[0][:, len(FORCED):].reshape(-1).tolist())) > 2   # tokens vary
    if variant == "timestamps":
        assert (ref[0][:, len(FORCED)] >= TS_BEGIN).all()
    # the returned tokens are the call's own: the next call leaves them
    assert out[0].data_ptr() != again[0].data_ptr()


def test_counters_read_replays_as_positions_less_eager(graph_on_cpu):
    params = _params()
    runs = []
    for B, kw in ((3, {}), (3, {}), (2, VARIANTS["timestamps"])):
        tokens, _ = D.greedy_decode(params, _mel(B), CFG, FORCED, MAXLEN, torch.float32,
                                    fused=True, **kw)
        runs.append((_positions(tokens, len(FORCED), CFG.eos_token_id, MAXLEN),
                     len(FORCED) + (1 if kw else 0)))
    counts = D.graph_counters()
    positions = sum(n for n, _ in runs)
    assert counts["eager_positions"] == sum(e for _, e in runs)
    assert counts["replays"] == positions - counts["eager_positions"]
    assert counts["captures"] == 2   # B 3 once for both calls, then B 2 with timestamps
    assert len(D._GRAPHS) == 2


# ----------------------------------------------------------- the buffers' key

def _tokenizer_evaluator(params, tmp_path, name, **kw):
    cfg = EvalConfig(max_length=MAXLEN, batch_size=2, output_dir=str(tmp_path / name),
                     compute_dtype=torch.float32, **kw)
    return OfflineEvaluator(CFG, params, load_tokenizer(None), cfg)


def _batch(B=2, seed=5):
    return {"mel": _mel(B, seed=seed).numpy(), "text": ["ein test", "noch einer"][:B]}


def test_two_evaluators_over_one_params_share_one_capture(graph_on_cpu, monkeypatch,
                                                         tmp_path):
    """The benchmark's warm-up evaluator and its window's, over one params
    tree (the fused route asked for: on the CPU the default is plain)."""
    monkeypatch.setenv("ASR_TPU_FUSED_DECODE", "1")
    params = _params()
    first = _tokenizer_evaluator(params, tmp_path, "warmup").run([_batch()])
    second = _tokenizer_evaluator(params, tmp_path, "window").run([_batch(), _batch(seed=6)])
    assert D.graph_counters()["captures"] == 1 and len(D._GRAPHS) == 1
    assert first["results"][0]["predicted"] == second["results"][0]["predicted"]


@pytest.mark.parametrize("change", ["weights", "rows", "kv_int8", "suppress", "max_length",
                                    "timestamps", "compute_dtype"])
def test_key_misses_on_changed_weights_rows_or_options(graph_on_cpu, change):
    params = _params()
    base = dict(max_length=MAXLEN, compute_dtype=torch.float32, fused=True)
    D.greedy_decode(params, _mel(2), CFG, FORCED, **base)
    entry = next(iter(D._GRAPHS.values()))
    B, kw = 2, dict(base)
    if change == "weights":
        params = _params(seed=3)
    elif change == "rows":
        B = 3
    elif change == "kv_int8":
        kw["kv_int8"] = True
    elif change == "suppress":
        kw["suppress_tokens"] = [3]
    elif change == "max_length":
        kw["max_length"] = MAXLEN - 4
    elif change == "timestamps":
        kw.update(VARIANTS["timestamps"])
    else:
        kw["compute_dtype"] = torch.bfloat16
    D.greedy_decode(params, _mel(B), CFG, FORCED, **kw)
    assert D.graph_counters()["captures"] == 2
    if change == "weights":   # the same shape: its buffers kept, the graph anew
        assert len(D._GRAPHS) == 1 and next(iter(D._GRAPHS.values())) is entry
    else:
        assert len(D._GRAPHS) == 2
    D.greedy_decode(params, _mel(B), CFG, FORCED, **kw)
    assert D.graph_counters()["captures"] == 2   # and then hits


def test_least_recently_used_shape_dropped(graph_on_cpu):
    params = _params()
    for B in (1, 2, 1, 3):
        D.greedy_decode(params, _mel(B), CFG, FORCED, 8, torch.float32, fused=True)
    assert len(D._GRAPHS) == D.GRAPH_SHAPES == 2
    assert sorted(k[1] for k in D._GRAPHS) == [1, 3]
    D.release_graphs()
    assert not D._GRAPHS


def test_trace_reports_the_graph_counters(graph_on_cpu, tmp_path):
    params = _params()
    D.greedy_decode(params, _mel(2), CFG, FORCED, 8, torch.float32, fused=True)
    with P.trace(str(tmp_path)):
        tokens, _ = D.greedy_decode(params, _mel(2), CFG, FORCED, 8, torch.float32,
                                    fused=True)
    counters = json.loads((tmp_path / "program_counters.json").read_text())["counters"]
    n = _positions(tokens, len(FORCED), CFG.eos_token_id, 8)
    assert counters["decode_graph"] == {"captures": 0, "replays": n - len(FORCED),
                                        "eager_positions": len(FORCED)}


# ------------------------------------------------------------------ the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph of the decoder kernels)")
    return torch.device("cuda")


def _eager(monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(D, "uses_graph", lambda *a: False)
        return fn()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [32, 320])   # a cache of 128, and of 384: chunks past pos
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_position_tensor_equals_int_bit_for_bit(dev, dtype, T):
    """On the card the kernels read the position: q, the cache rows and the
    self attention equal the int position's bit for bit, at every position
    of the cache (the core's chunks past pos only take their ticket)."""
    w, s, b, ln = (tuple(t.to(dev) for t in v) if isinstance(v, tuple)
                   else {k: t.to(dev) for k, t in v.items()}
                   for v in _layer_operands(dtype, True))
    B, cache = 5, D._round_up(T, 128)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((B, CFG.d_model), generator=g, device=dev).to(dtype)
    pos_dev = torch.zeros((1,), dtype=torch.long, device=dev)
    for p in sorted({0, 1, T // 2, 255 % T, T - 1}):
        pos_dev.fill_(p)
        caches = {}
        for kind, at in (("int", p), ("card", pos_dev)):
            ck = torch.randn((3, B, cache, CFG.d_model), generator=g, device=dev).to(dtype)
            if kind == "card":
                ck.copy_(caches["int"][1])
            cv = ck.clone()
            q, _, _ = DF.fused_qkv(x, ln[0], ln[1], w["q"], b["q"], w["k"], w["v"], b["v"],
                                   wk_scale=s["k"], layer_idx=1, cache_k=ck, cache_v=cv,
                                   pos=p if kind == "int" else pos_dev)
            o = DF.fused_attn(x, ck, cv, w["o"], b["o"], q=q, pos=at, wo_scale=s["o"],
                              layer_idx=1)
            caches[kind] = (q, ck, cv, o)
        for a, r in zip(caches["card"], caches["int"]):
            assert torch.equal(a, r), p


def _card_decode(dev, B, kind, cfg=CFG, max_length=MAXLEN, seed=1):
    params = _params(cfg, seed=seed, device=dev)
    W.cast_matmul_weights_(params, torch.bfloat16)
    kw = dict(kv_int8=True, w_int8=True) if kind == "int8" else {}
    return params, _mel(B, cfg, device=dev), kw


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("B", [32, 5])
def test_card_replayed_tokens_equal_eager(dev, monkeypatch, B, kind):
    """Greedy through the CUDA graph gives the host loop's tokens and
    lengths bit for bit; the counters read replays = positions - eager, one
    capture; the decoder kernels' launch counts are the host loop's."""
    params, mel, kw = _card_decode(dev, B, kind)
    args = (params, mel, CFG, FORCED, MAXLEN, torch.bfloat16)
    DF.reset_kernel_launches()
    ref = _eager(monkeypatch, lambda: D.greedy_decode(*args, **kw))
    eager_launches = DF.kernel_launches()
    D.release_graphs()
    D.reset_graph_counters()
    DF.reset_kernel_launches()
    out = D.greedy_decode(*args, **kw)
    launches = DF.kernel_launches()
    again = D.greedy_decode(*args, **kw)
    for o in (out, again):
        assert torch.equal(o[0], ref[0]) and torch.equal(o[1], ref[1])
    assert len(set(ref[0][:, len(FORCED):].reshape(-1).tolist())) > 2
    n = _positions(ref[0].cpu(), len(FORCED), CFG.eos_token_id, MAXLEN)
    counts = D.graph_counters()
    assert counts == {"captures": 1, "replays": 2 * (n - len(FORCED)),
                      "eager_positions": 2 * len(FORCED)}
    assert launches == eager_launches


@pytest.mark.cuda
def test_card_long_cache_replays_equal_eager(dev, monkeypatch):
    """A cache of 384 (two attention chunks, the second past pos for most
    positions) through the graph: the host loop's tokens."""
    cfg = dataclasses.replace(CFG, max_target_positions=448)
    params, mel, _ = _card_decode(dev, 4, "bf16", cfg)
    args = (params, mel, cfg, FORCED, 300, torch.bfloat16)
    ref = _eager(monkeypatch, lambda: D.greedy_decode(*args, suppress_tokens=[cfg.eos_token_id]))
    out = D.greedy_decode(*args, suppress_tokens=[cfg.eos_token_id])
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert int(ref[1].min()) == 300


@pytest.mark.cuda
def test_card_changed_weights_capture_again(dev, monkeypatch):
    params, mel, _ = _card_decode(dev, 5, "bf16")
    other, _, _ = _card_decode(dev, 5, "bf16", seed=4)
    D.release_graphs()
    D.reset_graph_counters()
    for p in (params, other, params):
        out = D.greedy_decode(p, mel, CFG, FORCED, MAXLEN, torch.bfloat16)
        ref = _eager(monkeypatch, lambda: D.greedy_decode(p, mel, CFG, FORCED, MAXLEN,
                                                          torch.bfloat16))
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert D.graph_counters()["captures"] == 3 and len(D._GRAPHS) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_beam_search_keeps_the_int_position(dev, monkeypatch, dtype):
    """Beam search runs the kernels' int form through the host, no graph:
    the fused beam decode's tokens are the plain step's (fp32), and the
    same twice."""
    params, mel, _ = _card_decode(dev, 3, "bf16")
    D.reset_graph_counters()
    kw = dict(num_beams=3, compute_dtype=dtype)
    fused = D.make_decode_fn(CFG, FORCED, 16, fused=True, **kw)(params, mel)
    again = D.make_decode_fn(CFG, FORCED, 16, fused=True, **kw)(params, mel)
    assert torch.equal(fused[0], again[0])
    if dtype == torch.float32:
        plain = D.make_decode_fn(CFG, FORCED, 16, fused=False, **kw)(params, mel)
        assert torch.equal(fused[0], plain[0]) and torch.equal(fused[1], plain[1])
    assert D.graph_counters() == {"captures": 0, "replays": 0, "eager_positions": 0}

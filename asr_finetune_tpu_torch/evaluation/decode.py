"""Greedy and beam-search decoding (counterpart of asr_finetune_tpu/evaluation/decode.py).

One Python loop over decode steps with a preallocated KV cache, early exit
once every row has emitted <|endoftext|> (greedy) or every utterance's beam
search is done (the JAX `lax.while_loop`). The forced prefix,
`suppress_tokens`, `begin_suppress_tokens` and Whisper's timestamp grammar
behave as in the JAX functions; beam search has HF `BeamSearchScorer`'s
semantics (beam_decode says which).

Fused path: by default on a CUDA device when the decoder's head dim is 64
(at any beam width), each step runs the fused layer kernels
(W.decode_step_fused) after `_cast_decoder_weights` and `_prepare_fused`;
LoRA adapters are merged into the weights first (training/lora.merge_adapters),
so over an int8 base the kernels meet mixed int8/float weights. The plain
W.decode_step runs otherwise: on the CPU, for other head dims, or when the
caller passes fused=False; it takes the adapters unmerged. `quant`
(ops/quant.QuantConfig) is how the encoder and the cross K/V precompute
multiply int8 weights. kv_int8 quantizes the cross K/V to int8
(W.quantize_cross_kv), w_int8 the decoder's float weights, both for the
token loop only.

Under tensor parallelism (--tp > 1, the eval decode of a training run)
each rank holds its slice of the model: the decode takes the plain step
over the rank's heads, o and fc2 summed over the model group, with the
rank's columns of each adapter's b. This is the JAX rule (decode.py
:628-659, `_use_fused_multichip`): with a model axis it keeps the
auto-sharded XLA decode. A fused decode asked for under tp raises.

Greedy on the fused route on a CUDA device (`uses_graph`): one position
of the token loop is captured once as a CUDA graph and replayed at every
later position, in place of the ~290 launches a position the host would
issue. The graph's position lives on the card (a one-element int64 tensor
the kernels and the token gather read, incremented inside the graph), so
one capture serves every position. Its buffers, made once per batch shape
and kept at module level (`GRAPH_SHAPES` shapes, the least recently used
dropped; `release_graphs`): the self cache, the padded cross K/V, the
tokens, the finished flags, the position, the last timestamps, the fp32
tied logits weight and the suppress bias; and the decoder weights a call
makes anew (cast, merged with adapters, quantized), copied there, while
the caller's own are read in place. A graph holds the addresses of the
weights it was captured over: the caller's other weights (another model)
capture anew. The forced prefix and the first
free position run eagerly on those buffers, and with the timestamp
grammar so does the next one (its rule reads t); the loop's test still
reads the finished flags between replays. Counters (`graph_counters`,
also in utils/profiling.trace's program_counters.json): captures, replays
and greedy positions run eagerly.

Spans (utils/profiling.py): `decode.prepare` around everything before the
token loop (the adapter merge, the encoder, the cross K/V), then one
`decode.position` a step, which ends with the loop's test for the next
step; the test's read of the finished flags, the host's wait for the
card, is `decode.sync` (the first test, before position 0, is a
`decode.sync` of its own). Greedy and beam search alike.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Iterator, Optional, Sequence, Tuple

import torch

from ..models import whisper as W
from ..models.configs import WhisperConfig
from ..ops import decoder_fused
from ..ops import quant as Q
from ..parallel import mesh
from ..training.lora import merge_adapters, tp_local
from ..utils import profiling

Params = dict

# whisper generation_config.max_initial_timestamp = 1.0 s at 0.02 s/token
MAX_INITIAL_TIMESTAMP_INDEX = 50


def _fused_head_dim_ok(cfg: WhisperConfig) -> bool:
    """The fused kernels reduce per 64-dim head (decoder_fused.HEAD_DIM)."""
    return cfg.d_model // cfg.decoder_heads == decoder_fused.HEAD_DIM


def _fused_env() -> Optional[bool]:
    """ASR_TPU_FUSED_DECODE, the JAX decode's routing override, read at every
    call: 1/true/yes/on → True, 0/false/no/off/"" → False, unset → None;
    any other value raises (the JAX spellings and rule)."""
    env = os.environ.get("ASR_TPU_FUSED_DECODE")
    if env is None:
        return None
    low = env.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(
        f"ASR_TPU_FUSED_DECODE={env!r}: use 1/true/yes/on or 0/false/no/off")


def _fused_default(cfg: WhisperConfig, device: torch.device) -> bool:
    """ASR_TPU_FUSED_DECODE when set (=1 with heads other than 64-dim
    raises, where JAX warns and takes its plain path: the port never gives
    way quietly); else fused kernels on a CUDA device with 64-dim heads. The
    JAX rule also asks for a single device, because a Pallas call cannot be
    partitioned over a mesh; a decode here runs on mel's one device however
    many cards the host has, so the device count does not enter, but under
    tensor parallelism (the rank holds a slice of the model) the decode is
    plain and =1 raises."""
    env = _fused_env()
    if env is not None:
        if env and not _fused_head_dim_ok(cfg):
            raise ValueError(
                f"ASR_TPU_FUSED_DECODE=1 but the fused decode requires 64-dim heads, "
                f"got {cfg.d_model // cfg.decoder_heads}")
        if env:
            _check_not_split("ASR_TPU_FUSED_DECODE=1")
        return env
    return device.type == "cuda" and _fused_head_dim_ok(cfg) and mesh.model_world() == 1


def _check_not_split(what: str) -> None:
    """Raise under tp > 1: the fused kernels read whole weights."""
    if mesh.model_world() > 1:
        raise ValueError(f"{what}: the fused decode reads whole weights, and under "
                         f"--tp {mesh.model_world()} this rank holds a slice (the plain "
                         "step decodes tensor-parallel, as the JAX decode does)")


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _cast_decoder_weights(params: Params, dtype: torch.dtype) -> Params:
    """Pre-cast the decoder's float matmul weights and biases (not the
    layer-norm params, which the kernels read in fp32) so the fused kernels
    stream compute-dtype bytes. int8 weights stay int8 and their `*_scale`
    stays fp32: the kernels apply it after the product, and a cast would
    stack a bf16 rounding on the int8 error. Free when the weights are in
    dtype already, as after run.build_model with --bf16
    (W.cast_matmul_weights_)."""
    def leaf(k, v):
        if k.endswith("_scale") or not v.is_floating_point():
            return v
        return v.to(dtype)

    def cast(t):
        return {k: cast(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in t.items()}

    layers = dict(params["decoder"]["layers"])
    for blk in ("self_attn", "cross_attn", "mlp"):
        layers[blk] = cast(layers[blk])
    dec = dict(params["decoder"], layers=layers,
               embed=params["decoder"]["embed"].to(dtype),
               pos=params["decoder"]["pos"].to(dtype))
    return {**params, "decoder": dec}


def _prepare_fused(enc_out: torch.Tensor, cross_kv: Params, max_length: int,
                   compute_dtype: torch.dtype, out: Optional[Params] = None
                   ) -> Tuple[Params, int, int]:
    """Once per decode call: pad cross K/V on the source axis to a
    128-multiple (1500 → 1536 at large-v3, so the kernel masks s_valid on
    the main path) and flatten heads to the dense (L, B, S_pad, d) layout,
    int8 K/V as it is with its scales expanded to (L, B, d); pick a
    128-multiple cache length. out: buffers of that layout to write into,
    whose padded tail is zero already (the graph's)."""
    S_real = int(enc_out.shape[1])
    S_pad = _round_up(S_real, 128)

    def pad_dense(name, dtype):
        a = cross_kv[name]
        L, B, S, H, hd = a.shape
        buf = out[name] if out is not None else torch.zeros(
            (L, B, S_pad, H * hd), dtype=dtype, device=a.device)
        buf[:, :, :S] = a.reshape(L, B, S, H * hd)
        return buf

    def expand(name):   # (L, B, 1, H, 1) → (L, B, d): index j has head j // hd
        hd = cross_kv["k_q8"].shape[-1]
        e = cross_kv[name[0] + "_scale"][:, :, 0, :, 0].repeat_interleave(hd, dim=-1)
        return out[name].copy_(e) if out is not None else e.contiguous()

    if "k_q8" in cross_kv:
        ckv = {"k_q8": pad_dense("k_q8", torch.int8), "v_q8": pad_dense("v_q8", torch.int8),
               "k_scale_d": expand("k_scale_d"), "v_scale_d": expand("v_scale_d")}
    else:
        ckv = {"k": pad_dense("k", compute_dtype), "v": pad_dense("v", compute_dtype)}
    return ckv, S_real, _round_up(max_length, 128)


def _suppress_bias(vocab: int, suppress_tokens: Optional[Sequence[int]],
                   device) -> Optional[torch.Tensor]:
    """Additive logits bias: -inf at suppressed ids (HF SuppressTokens)."""
    if not suppress_tokens:
        return None
    bias = torch.zeros((vocab,), dtype=torch.float32, device=device)
    bias[torch.as_tensor(list(suppress_tokens), dtype=torch.long,
                         device=device)] = float("-inf")
    return bias


def _apply_timestamp_rules(logits: torch.Tensor, prev: torch.Tensor,
                           prev2: torch.Tensor, last_ts: torch.Tensor,
                           is_begin: bool, ts_begin: int, eot: int,
                           no_ts_id: int) -> torch.Tensor:
    """Whisper's timestamp grammar on (N, V) fp32 logits (HF's
    WhisperTimeStampLogitsProcessor semantics, as the JAX function):

    - <|notimestamps|> never generated
    - after an unpaired timestamp: only a timestamp or eot
    - after a completed pair: no timestamp
    - timestamps non-decreasing (a pair's close may equal its open; a new
      pair's open must exceed the last close)
    - the first free position must be a timestamp, capped at
      max_initial_timestamp
    - if total timestamp probability beats the best text token, force a
      timestamp
    """
    neg = float("-inf")
    V = logits.shape[-1]
    ar = torch.arange(V, device=logits.device)
    is_ts_tok = ar >= ts_begin                                     # (V,)
    prev_is_ts = prev >= ts_begin                                  # (N,)
    prev2_is_ts = prev2 >= ts_begin

    logits = logits.masked_fill((ar == no_ts_id)[None, :], neg)

    need_ts_or_eot = prev_is_ts & ~prev2_is_ts
    logits = logits.masked_fill(need_ts_or_eot[:, None] & (ar < eot)[None, :], neg)
    pair_done = prev_is_ts & prev2_is_ts
    logits = logits.masked_fill(pair_done[:, None] & is_ts_tok[None, :], neg)

    have_ts = last_ts >= ts_begin
    lower = torch.where(need_ts_or_eot, last_ts, last_ts + 1)
    if not is_begin:
        logits = logits.masked_fill(
            have_ts[:, None] & is_ts_tok[None, :] & (ar[None, :] < lower[:, None]),
            neg)
    else:
        logits = logits.masked_fill(~is_ts_tok[None, :], neg)
        logits = logits.masked_fill(
            (ar > ts_begin + MAX_INITIAL_TIMESTAMP_INDEX)[None, :], neg)

    logprobs = torch.log_softmax(logits, dim=-1)
    ts_lp = torch.logsumexp(logprobs.masked_fill(~is_ts_tok[None, :], neg), dim=-1)
    text_lp = logprobs.masked_fill(is_ts_tok[None, :], neg).amax(dim=-1)
    force_ts = ts_lp > text_lp
    return logits.masked_fill(force_ts[:, None] & ~is_ts_tok[None, :], neg)


def _quantize_decoder_weights(params: Params) -> Params:
    """int8 decoder weights for the token loop (w_int8): applied after the
    encode and the cross K/V precompute, so the one-time full-sequence math
    stays in full precision; the fused kernels and the plain step both read
    the int8 form."""
    dec = dict(params["decoder"], layers=Q.quantize_tree_int8(params["decoder"]["layers"],
                                                              split=True))
    return {**params, "decoder": dec}


def _resolve_fused(fused: Optional[bool], cfg: WhisperConfig,
                   device: torch.device) -> bool:
    """The routing rule: an explicit `fused` wins; else ASR_TPU_FUSED_DECODE
    when set; else fused by default on a CUDA device with 64-dim heads, at
    any beam width (the JAX package routes more than 8 beams to
    its plain step; the CUDA kernels have no such bound); fused=True with a
    model it cannot serve, or under tp > 1, raises."""
    if fused is None:
        return _fused_default(cfg, device)
    if fused and not _fused_head_dim_ok(cfg):
        raise ValueError(
            f"fused decode requires 64-dim heads, got "
            f"{cfg.d_model // cfg.decoder_heads} "
            f"(d_model={cfg.d_model}, heads={cfg.decoder_heads})")
    if fused:
        _check_not_split("fused=True")
    return fused


def _encode_cross(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
                  compute_dtype: torch.dtype, kv_int8: bool, fused: bool,
                  adapters: Optional[Params], quant: Optional[Q.QuantConfig]):
    """A decode call's work on the audio: adapters merged (fused), the
    encoder, the cross K/V at mel's B rows (int8 with kv_int8). Returns
    (params, adapters, enc_out, cross_kv)."""
    if fused and adapters is not None:
        params, adapters = merge_adapters(params, adapters), None
    adapters = tp_local(adapters)
    enc_out = W.encode(params, mel, cfg, compute_dtype, adapters=adapters,
                       quant=quant)
    cross_kv = W.precompute_cross_kv(params, enc_out, cfg, adapters, quant)
    if kv_int8:
        cross_kv = W.quantize_cross_kv(cross_kv)
    return params, adapters, enc_out, cross_kv


def _decoder_weights(params: Params, compute_dtype: torch.dtype, w_int8: bool,
                     fused: bool, quant: Optional[Q.QuantConfig]) -> Params:
    """The decoder weights as the token loop reads them: cast (fused) and
    quantized (w_int8)."""
    if fused:
        params = _cast_decoder_weights(params, compute_dtype)
    if w_int8:
        params = _quantize_decoder_weights(params)
        if quant is not None and quant.matmul and not fused:
            # the plain step multiplies them as W8A8: the kernel's K-major copies
            params = {**params, "decoder": Q.add_k_major_copies(params["decoder"])}
    return params


def _prepare_decode(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
                    max_length: int, rows: int, compute_dtype: torch.dtype,
                    kv_int8: bool, w_int8: bool, fused: bool,
                    adapters: Optional[Params], quant: Optional[Q.QuantConfig],
                    cross_group: int = 1):
    """Everything of a decode call before its token loop: _encode_cross (the
    cross K/V laid out for the kernels when fused), _decoder_weights, a
    zeroed cache of `rows` rows. Returns (step(token, t, cache,
    ancestry=None) → (logits, cache), cache)."""
    params, adapters, enc_out, cross_kv = _encode_cross(
        params, mel, cfg, compute_dtype, kv_int8, fused, adapters, quant)
    cache_len = max_length
    if fused:
        cross_kv, s_real, cache_len = _prepare_fused(
            enc_out, cross_kv, max_length, compute_dtype)
    params = _decoder_weights(params, compute_dtype, w_int8, fused, quant)
    cache = W.init_cache(cfg, rows, cache_len, dtype=compute_dtype,
                         dense=fused, device=mel.device)
    logits_w = W.tied_logits_weight(params["decoder"]["embed"], compute_dtype)

    def step(token, t, cache, ancestry=None):
        if fused:
            return W.decode_step_fused(params, token, t, cache, cross_kv, cfg,
                                       s_real, compute_dtype, logits_w,
                                       ancestry=ancestry, cross_group=cross_group)
        return W.decode_step(params, token, t, cache, cross_kv, cfg,
                             compute_dtype, logits_w, adapters, quant,
                             cross_group=cross_group)
    return step, cache


def _timestamp_prev2(tokens: torch.Tensor, t: int, n_forced: int,
                     timestamp_begin: int) -> torch.Tensor:
    """The token before the current one, for the timestamp grammar: HF
    treats it as a timestamp while fewer than 2 tokens have been sampled,
    so the initial segment-open timestamp is followed by text."""
    if t + 1 - n_forced < 2:
        return torch.full_like(tokens[:, 0], timestamp_begin)
    return tokens[:, max(t - 1, 0)]


def _loop_done(t: int, max_length: int, finished: torch.Tensor) -> bool:
    """A decode loop's test before position t: the length is reached, or
    every row (utterance) is finished, which the host reads from the device
    (the span `decode.sync`)."""
    if t >= max_length - 1:
        return True
    with profiling.span("decode.sync"):
        return bool(finished.all())


class _GreedyRules:
    """A greedy decode's per-call constants: the forced prefix, eot, the
    suppress biases and the timestamp grammar's ids."""

    def __init__(self, cfg: WhisperConfig, forced_tokens: Sequence[int],
                 suppress_tokens, begin_suppress_tokens, timestamp_begin,
                 no_timestamps_id, device):
        self.forced = list(forced_tokens)
        self.n_forced = len(self.forced)
        if self.n_forced < 1:
            raise ValueError("forced_tokens must at least contain sot")
        self.eot = cfg.eos_token_id
        self.bias = _suppress_bias(cfg.vocab_size, suppress_tokens, device)
        self.begin_bias = _suppress_bias(cfg.vocab_size, begin_suppress_tokens, device)
        self.with_ts = timestamp_begin is not None
        self.ts_begin = timestamp_begin
        self.no_ts_id = (no_timestamps_id if no_timestamps_id is not None
                         else (timestamp_begin - 1 if self.with_ts else 0))

    def captured(self, t: int) -> bool:
        """Position t reads nothing of t but the position on the card: past
        the forced prefix and the first free position, and with the
        timestamp grammar past the position after it (HF's rule for the
        token before the current one reads t there)."""
        return t + 1 > self.n_forced and (not self.with_ts or t + 1 - self.n_forced >= 2)


def _eager_position(step, cache, tokens, finished, last_ts, t: int, g: _GreedyRules):
    """Greedy position t through the host: the step, the suppress biases,
    the timestamp grammar, the forced token or the argmax; tokens, finished
    and last_ts updated in place. Returns the cache."""
    cur = tokens[:, t]
    logits, cache = step(cur, t, cache)
    if g.bias is not None:
        logits = logits + g.bias
    is_begin = (t + 1) == g.n_forced
    if g.begin_bias is not None and is_begin:
        logits = logits + g.begin_bias
    if g.with_ts:
        logits = _apply_timestamp_rules(
            logits, cur, _timestamp_prev2(tokens, t, g.n_forced, g.ts_begin),
            last_ts, is_begin, g.ts_begin, g.eot, g.no_ts_id)
    in_prefix = (t + 1) < g.n_forced
    if in_prefix:
        nxt = torch.full_like(cur, g.forced[t + 1])
    else:
        nxt = torch.argmax(logits, dim=-1)
    nxt = torch.where(finished, torch.full_like(nxt, g.eot), nxt)
    tokens[:, t + 1] = nxt
    if g.with_ts:
        last_ts.copy_(torch.where(nxt >= g.ts_begin, nxt, last_ts))
    if not in_prefix:
        finished |= nxt == g.eot
    return cache


def _captured_position(step, e: "_GreedyGraph", g: _GreedyRules) -> None:
    """A position g.captured() admits at the position on the card, e.pos,
    all on the card and in place (what the graph holds): _eager_position's
    operations, the token read and written at e.pos and e.pos + 1, then
    e.pos + 1."""
    pos = e.pos
    cur = e.tokens.index_select(1, pos)[:, 0]
    logits, _ = step(cur, pos, e.cache)
    if g.bias is not None:
        logits = logits + g.bias
    if g.with_ts:
        logits = _apply_timestamp_rules(
            logits, cur, e.tokens.index_select(1, pos - 1)[:, 0], e.last_ts, False,
            g.ts_begin, g.eot, g.no_ts_id)
    nxt = torch.argmax(logits, dim=-1)
    nxt = torch.where(e.finished, torch.full_like(nxt, g.eot), nxt)
    e.tokens.index_copy_(1, pos + 1, nxt[:, None])
    if g.with_ts:
        e.last_ts.copy_(torch.where(nxt >= g.ts_begin, nxt, e.last_ts))
    e.finished |= nxt == g.eot
    pos += 1


def uses_graph(device: torch.device, fused: bool, num_beams: int) -> bool:
    """The rule for the captured greedy position: the fused kernels, on a
    CUDA device, greedy. The CPU, the plain step (tp > 1 among its cases)
    and beam search run every position through the host."""
    return device.type == "cuda" and fused and num_beams <= 1


GRAPH_SHAPES = 2   # batch shapes whose buffers and graph stay (least recently used dropped)
_GRAPHS: "OrderedDict[tuple, _GreedyGraph]" = OrderedDict()
_GRAPH_COUNTS = {"captures": 0, "replays": 0, "eager_positions": 0}


def graph_counters() -> dict:
    """Since reset_graph_counters(): greedy positions captured as a CUDA
    graph, replayed, and run through the host."""
    return dict(_GRAPH_COUNTS)


def reset_graph_counters() -> None:
    for k in _GRAPH_COUNTS:
        _GRAPH_COUNTS[k] = 0


def release_graphs() -> None:
    """Drop every batch shape's buffers and graph (the trainer's eval ends
    so, giving the memory back to training)."""
    _GRAPHS.clear()


profiling.add_counters("decode_graph", graph_counters)


def _leaves(tree: Params, path: tuple = ()):
    """(path, tensor) of every tensor of a tree, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        elif isinstance(v, torch.Tensor):
            yield path + (k,), v


class _Captured:
    """`body` captured once as a CUDA graph on a side stream, replayed on the
    current one. The decoder kernels it launches count at each replay
    (decoder_fused.credit_launches), not at the capture, which runs none."""

    def __init__(self, body, device: torch.device):
        k0, w0 = decoder_fused.kernel_launches(), dict(decoder_fused.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                body()
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
        k1 = decoder_fused.kernel_launches()
        self.kernels = {k: n - k0[k] for k, n in k1.items() if n != k0[k]}
        self.wrappers = {k: n - w0[k] for k, n in decoder_fused.LAUNCHES.items() if n != w0[k]}
        decoder_fused.credit_launches(self.kernels, self.wrappers, -1)

    def replay(self) -> None:
        self.graph.replay()
        decoder_fused.credit_launches(self.kernels, self.wrappers, 1)


class _GreedyGraph:
    """One batch shape's buffers, made once, and the graph of a position
    captured over one set of decoder weights (`weights`: their
    addresses)."""

    def __init__(self, cfg: WhisperConfig, B: int, max_length: int, S_real: int,
                 compute_dtype: torch.dtype, kv_int8: bool, bias, device):
        self.derived = {}   # path → the buffer of a decoder weight made anew each call
        L, d = cfg.decoder_layers, cfg.d_model
        kw = dict(device=device)
        self.cache = W.init_cache(cfg, B, _round_up(max_length, 128), dtype=compute_dtype,
                                  dense=True, device=device)
        # the cross K/V's tail past S_real stays zero: _prepare_fused writes
        # the rows before it
        kv, S_pad = (torch.int8 if kv_int8 else compute_dtype), _round_up(S_real, 128)
        self.cross = {n: torch.zeros((L, B, S_pad, d), dtype=kv, **kw)
                      for n in (("k_q8", "v_q8") if kv_int8 else ("k", "v"))}
        if kv_int8:
            self.cross.update({n: torch.empty((L, B, d), dtype=torch.float32, **kw)
                               for n in ("k_scale_d", "v_scale_d")})
        self.tokens = torch.empty((B, max_length), dtype=torch.long, **kw)
        self.finished = torch.empty((B,), dtype=torch.bool, **kw)
        self.last_ts = torch.empty((B,), dtype=torch.long, **kw)
        self.pos = torch.zeros((1,), dtype=torch.long, **kw)
        self.bias = bias
        self.logits_w = None
        self.weights = None
        self.graph = None

    def bind(self, params: Params, own: set) -> Params:
        """The decoder weights where the graph reads them: the caller's own
        tensors (addresses in `own`) in place, so that a change made to them
        in place shows; those this call made (cast, merged with adapters or
        quantized, anew at every call) copied into the shape's buffers,
        whose addresses hold from call to call."""
        def place(t, path):
            if isinstance(t, dict):
                return {k: place(v, path + (k,)) for k, v in t.items()}
            if not isinstance(t, torch.Tensor) or t.data_ptr() in own:
                return t
            buf = self.derived.get(path)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                self.derived[path] = t   # this call's tensor becomes the buffer
                return t
            return buf.copy_(t)
        return {**params, "decoder": place(params["decoder"], ())}

    def start(self, params: Params, g: _GreedyRules, compute_dtype: torch.dtype) -> None:
        """A call's first state, as the host loop's: the cache zeroed, the
        tokens eot after sot, nothing finished; the tied logits weight of
        this call's embedding; the graph dropped if the decoder weights
        (params from bind) lie elsewhere than it read them."""
        for c in self.cache.values():
            c.zero_()
        self.tokens.fill_(g.eot)
        self.tokens[:, 0] = g.forced[0]
        self.finished.zero_()
        self.last_ts.zero_()
        self.logits_w = W.tied_logits_weight(params["decoder"]["embed"], compute_dtype,
                                             out=self.logits_w)
        weights = tuple((path, t.data_ptr(), tuple(t.shape), t.dtype)
                        for path, t in _leaves(params["decoder"]))
        if weights != self.weights:
            self.weights, self.graph = weights, None


def _prepare_graphed(params, mel, cfg, g: _GreedyRules, max_length: int,
                     compute_dtype: torch.dtype, kv_int8: bool, w_int8: bool,
                     adapters, quant, suppress_tokens):
    """_prepare_decode for the graph: the same work, into the buffers of
    mel's batch shape. Returns (step, the shape's _GreedyGraph)."""
    own = {t.data_ptr() for _, t in _leaves(params["decoder"])}
    params, _, enc_out, cross_kv = _encode_cross(params, mel, cfg, compute_dtype, kv_int8,
                                                 True, adapters, quant)
    B, S_real = int(mel.shape[0]), int(enc_out.shape[1])
    key = (mel.device, B, max_length, S_real, compute_dtype, kv_int8, w_int8,
           tuple(suppress_tokens or ()), g.eot, (g.ts_begin, g.no_ts_id) if g.with_ts else None,
           cfg.decoder_layers, cfg.d_model, cfg.vocab_size)
    e = _GRAPHS.pop(key, None)
    if e is None:
        while len(_GRAPHS) >= GRAPH_SHAPES:
            _GRAPHS.popitem(last=False)
        e = _GreedyGraph(cfg, B, max_length, S_real, compute_dtype, kv_int8, g.bias,
                         mel.device)
    _GRAPHS[key] = e
    g.bias = e.bias   # the values of this call's, where the graph reads them
    _prepare_fused(enc_out, cross_kv, max_length, compute_dtype, out=e.cross)
    params = e.bind(_decoder_weights(params, compute_dtype, w_int8, True, quant), own)
    e.start(params, g, compute_dtype)

    def step(token, pos, cache):
        return W.decode_step_fused(params, token, pos, cache, e.cross, cfg, S_real,
                                   compute_dtype, e.logits_w)
    return step, e


def greedy_decode(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
                  forced_tokens: Sequence[int], max_length: int = 225,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  suppress_tokens: Optional[Sequence[int]] = None,
                  begin_suppress_tokens: Optional[Sequence[int]] = None,
                  timestamp_begin: Optional[int] = None,
                  no_timestamps_id: Optional[int] = None,
                  kv_int8: bool = False,
                  w_int8: bool = False,
                  fused: Optional[bool] = None,
                  adapters: Optional[Params] = None,
                  quant: Optional[Q.QuantConfig] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, max_length), lengths (B,)), int64 on mel's device.

    tokens[:, 0] is <|startoftranscript|>; forced_tokens is the full prefix
    including sot. Positions past the emitted <|endoftext|> hold eot.
    suppress_tokens get -inf logits at every step, begin_suppress_tokens at
    the first unforced position only; with timestamp_begin set, Whisper's
    timestamp grammar is enforced. fused (default: on a CUDA device with
    64-dim heads) runs each step through the fused kernels, with the
    adapters merged into the weights first; on a CUDA device as one CUDA
    graph a position past the first free one (the module docstring)."""
    device = mel.device
    B = mel.shape[0]
    g = _GreedyRules(cfg, forced_tokens, suppress_tokens, begin_suppress_tokens,
                     timestamp_begin, no_timestamps_id, device)
    fused = _resolve_fused(fused, cfg, device)
    graphed = uses_graph(device, fused, 1)

    with torch.no_grad():
        with profiling.span("decode.prepare"):
            if graphed:
                step, e = _prepare_graphed(params, mel, cfg, g, max_length, compute_dtype,
                                           kv_int8, w_int8, adapters, quant, suppress_tokens)
                cache, tokens, finished, last_ts = e.cache, e.tokens, e.finished, e.last_ts
            else:
                step, cache = _prepare_decode(params, mel, cfg, max_length, B,
                                              compute_dtype, kv_int8, w_int8, fused,
                                              adapters, quant)
                tokens = torch.full((B, max_length), g.eot, dtype=torch.long, device=device)
                tokens[:, 0] = g.forced[0]
                finished = torch.zeros((B,), dtype=torch.bool, device=device)
                last_ts = torch.zeros((B,), dtype=torch.long, device=device)
        t = 0
        done = _loop_done(t, max_length, finished)
        while not done:
            with profiling.span("decode.position"):
                if graphed and g.captured(t):
                    if not g.captured(t - 1):   # the call's first: the position to the card
                        e.pos.fill_(t)
                    if e.graph is None:
                        e.graph = _Captured(lambda: _captured_position(step, e, g), device)
                        _GRAPH_COUNTS["captures"] += 1
                    e.graph.replay()
                    _GRAPH_COUNTS["replays"] += 1
                else:
                    cache = _eager_position(step, cache, tokens, finished, last_ts, t, g)
                    _GRAPH_COUNTS["eager_positions"] += 1
                t += 1
                done = _loop_done(t, max_length, finished)
        if graphed:   # the buffers serve the next call
            tokens = tokens.clone()

    before_eot = torch.cumsum((tokens == g.eot).long(), dim=1) == 0
    lengths = torch.clamp(before_eot.sum(dim=1) + 1, max=max_length)
    return tokens, lengths


BEAM_NEG = -1e9   # the score of a slot that holds no hypothesis (JAX NEG)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis and their indices, the
    lowest index first among equals, as lax.top_k (torch.topk promises no
    order among ties; during the forced prefix hundreds of candidates tie
    at exactly BEAM_NEG)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) gathered on the beam axis with idx (B, K')."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class BeamState:
    """The beam loop's state, the JAX while_loop carry: step t, running
    tokens (B, K, max_length) and scores (B, K), the finished set
    (fin_tokens, fin_scores, fin_lens), last timestamps, per-utterance done
    and, on the fused path, the ancestry map anc (B, K, cache_len) int32
    (anc[b, k, t] = the beam row whose cache slot t holds hypothesis
    (b, k)'s key at position t)."""

    def __init__(self, B: int, K: int, max_length: int, cache_len: int,
                 sot: int, eot: int, device: torch.device):
        kw = dict(device=device)
        self.t = 0
        self.tokens = torch.full((B, K, max_length), eot, dtype=torch.long, **kw)
        self.tokens[:, :, 0] = sot
        # beam 0 live, the others start at BEAM_NEG so step 1 doesn't duplicate
        self.scores = torch.where(torch.arange(K, **kw) == 0, 0.0, BEAM_NEG
                                  ).to(torch.float32)[None].repeat(B, 1)
        self.fin_scores = torch.full((B, K), BEAM_NEG, dtype=torch.float32, **kw)
        self.fin_tokens = torch.full((B, K, max_length), eot, dtype=torch.long, **kw)
        self.fin_lens = torch.ones((B, K), dtype=torch.long, **kw)
        self.last_ts = torch.zeros((B, K), dtype=torch.long, **kw)
        self.done = torch.zeros((B,), dtype=torch.bool, **kw)
        self.anc = torch.zeros((B, K, cache_len), dtype=torch.int32, **kw)


def beam_states(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
                forced_tokens: Sequence[int], max_length: int = 225,
                num_beams: int = 4, length_penalty: float = 1.0,
                compute_dtype: torch.dtype = torch.bfloat16,
                suppress_tokens: Optional[Sequence[int]] = None,
                begin_suppress_tokens: Optional[Sequence[int]] = None,
                timestamp_begin: Optional[int] = None,
                no_timestamps_id: Optional[int] = None,
                kv_int8: bool = False, w_int8: bool = False,
                fused: Optional[bool] = None,
                adapters: Optional[Params] = None,
                quant: Optional[Q.QuantConfig] = None) -> Iterator[BeamState]:
    """beam_decode's loop as a generator: the BeamState before the first
    step, then after each step until every utterance is done or the length
    is reached (the same object, updated in place). beam_decode finalizes
    the last one."""
    device = mel.device
    B, K = mel.shape[0], num_beams
    eot = cfg.eos_token_id
    forced = list(forced_tokens)
    n_forced = len(forced)
    if n_forced < 1:
        raise ValueError("forced_tokens must at least contain sot")
    bias = _suppress_bias(cfg.vocab_size, suppress_tokens, device)
    begin_bias = _suppress_bias(cfg.vocab_size, begin_suppress_tokens, device)
    with_ts = timestamp_begin is not None
    no_ts_id = (no_timestamps_id if no_timestamps_id is not None
                else (timestamp_begin - 1 if with_ts else 0))
    fused = _resolve_fused(fused, cfg, device)
    # A/B switch (chip_smoke.py times it): the fused kernels with the
    # conventional per-step reorder of the whole cache on the beam axis (HF
    # generate's `_reorder_cache`) instead of the ancestry map
    reorder = fused and os.environ.get("ASR_TPU_BEAM_REORDER", "0") == "1"
    ancestry = fused and not reorder
    f32 = torch.float32

    with torch.no_grad():
        # the cross K/V stays at B rows: the K hypotheses of an utterance
        # share it (cross_group), never replicated per beam
        with profiling.span("decode.prepare"):
            step, cache = _prepare_decode(params, mel, cfg, max_length, B * K,
                                          compute_dtype, kv_int8, w_int8, fused,
                                          adapters, quant, cross_group=K)
        st = BeamState(B, K, max_length, cache["k"].shape[2], forced[0], eot, device)
        own_rows = torch.arange(K, dtype=torch.int32, device=device)[None, :]
        rows = torch.arange(B, device=device)[:, None] * K
        rank_ok = torch.arange(2 * K, device=device)[None, :] < K
        yield st
        done = _loop_done(st.t, max_length, st.done)
        while not done:
            with profiling.span("decode.position"):
                t = st.t
                flat_tokens = st.tokens.reshape(B * K, max_length)
                cur = flat_tokens[:, t]
                if ancestry:
                    st.anc[:, :, t] = own_rows   # this step writes each row's own K/V at t
                    logits, cache = step(cur, t, cache, st.anc)
                else:
                    logits, cache = step(cur, t, cache)
                if bias is not None:
                    logits = logits + bias
                is_begin = (t + 1) == n_forced
                if begin_bias is not None and is_begin:
                    logits = logits + begin_bias
                if with_ts:
                    logits = _apply_timestamp_rules(
                        logits.float(), cur,
                        _timestamp_prev2(flat_tokens, t, n_forced, timestamp_begin),
                        st.last_ts.reshape(B * K), is_begin, timestamp_begin, eot, no_ts_id)
                logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, -1)
                V = logp.shape[-1]
                in_prefix = (t + 1) < n_forced
                if in_prefix:   # only the forced token is allowed
                    logp = torch.full_like(logp, BEAM_NEG)
                    logp[:, :, forced[t + 1]] = 0.0
                # generated length excludes the forced prompt (HF cur_len -
                # decoder_prompt_len); 0 at the first free position, where x / 0
                # = -inf keeps an eos-first hypothesis out: an fp32 tensor, as in
                # JAX (a Python float would raise); a CPU scalar, so no copy to
                # the device each step
                gen_len = torch.tensor(t + 1.0 - n_forced, dtype=f32) ** length_penalty

                # 2K candidates per step (HF beam_search's top_k(2 * num_beams))
                top_scores2, top_idx2 = _top_k((st.scores[:, :, None] + logp).reshape(B, K * V),
                                               2 * K)
                beam_idx2, tok_idx2 = top_idx2 // V, top_idx2 % V
                ended2 = (tok_idx2 == eot) & (not in_prefix)

                # finished adds: eos candidates at rank < K only (HF skips eos
                # beyond the top num_beams); frozen once the utterance is done
                fin_add = ended2 & rank_ok & ~st.done[:, None]
                cand_fin_scores = torch.where(fin_add, top_scores2 / gen_len, BEAM_NEG)
                cand_fin_tokens = _gather_beams(st.tokens, beam_idx2)
                cand_fin_tokens[:, :, t + 1] = tok_idx2
                keep_scores, keep_idx = _top_k(torch.cat([st.fin_scores, cand_fin_scores], 1), K)
                st.fin_tokens = _gather_beams(torch.cat([st.fin_tokens, cand_fin_tokens], 1),
                                              keep_idx)
                st.fin_lens = torch.cat([st.fin_lens, torch.full_like(tok_idx2, t + 2)],
                                        1).gather(1, keep_idx)
                st.fin_scores = keep_scores

                # running frontier: the best K non-eos candidates of the 2K
                top_scores, run_rank = _top_k(torch.where(ended2, 2 * BEAM_NEG, top_scores2), K)
                beam_idx = beam_idx2.gather(1, run_rank)
                tok_idx = tok_idx2.gather(1, run_rank)
                st.tokens = _gather_beams(st.tokens, beam_idx)
                st.tokens[:, :, t + 1] = tok_idx
                if with_ts:
                    st.last_ts = torch.where(tok_idx >= timestamp_begin, tok_idx,
                                             st.last_ts.gather(1, beam_idx))
                if ancestry:
                    # gather the ancestry rows, not the cache
                    st.anc = _gather_beams(st.anc, beam_idx).contiguous()
                else:
                    # the whole cache reordered on the beam axis, (L, B·K, T, ...)
                    flat_idx = (rows + beam_idx).reshape(-1)
                    cache = {k: v.index_select(1, flat_idx) for k, v in cache.items()}

                # per-utterance done (BeamHypotheses.is_done, early_stopping
                # False): K finished hypotheses and the worst kept beats the best
                # candidate's attainable normalized score at this length
                n_fin = (st.fin_scores > BEAM_NEG / 2).sum(dim=1)
                attainable = top_scores2[:, 0] / gen_len
                st.done |= (n_fin >= K) & (st.fin_scores.amin(dim=1) >= attainable)
                st.scores = top_scores
                st.t = t + 1
                done = _loop_done(st.t, max_length, st.done)
            yield st


def _finalize(st: BeamState, n_forced: int, length_penalty: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BeamSearchScorer.finalize: utterances not done at max length fold
    their K running beams into the finished set at the final generated
    length; each utterance's best hypothesis wins."""
    B, K = st.scores.shape
    dev = st.scores.device
    final_gen = torch.tensor(max(st.t + 1.0 - n_forced, 1.0), dtype=torch.float32
                             ) ** length_penalty
    run_scores = torch.where(st.done[:, None], BEAM_NEG, st.scores / final_gen)
    best = torch.argmax(torch.cat([st.fin_scores, run_scores], 1), dim=1)
    rows = torch.arange(B, device=dev)
    tokens = torch.cat([st.fin_tokens, st.tokens], 1)[rows, best]
    lengths = torch.cat([st.fin_lens, torch.full_like(st.fin_lens, st.t + 1)], 1)[rows, best]
    return tokens, lengths


def beam_decode(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
                forced_tokens: Sequence[int], max_length: int = 225,
                num_beams: int = 4, length_penalty: float = 1.0,
                compute_dtype: torch.dtype = torch.bfloat16,
                suppress_tokens: Optional[Sequence[int]] = None,
                begin_suppress_tokens: Optional[Sequence[int]] = None,
                timestamp_begin: Optional[int] = None,
                no_timestamps_id: Optional[int] = None,
                kv_int8: bool = False, w_int8: bool = False,
                fused: Optional[bool] = None,
                adapters: Optional[Params] = None,
                quant: Optional[Q.QuantConfig] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over B·num_beams hypothesis rows; returns the best beam's
    (tokens (B, max_length), lengths (B,)), int64 on mel's device.

    HF `generate(num_beams=K)` semantics (BeamSearchScorer), as the JAX
    beam_decode:
    - 2K candidates per step; eos candidates within the top K join the
      finished set (beyond rank K they are dropped), and the K running
      beams are the best K non-eos candidates;
    - finished score = summed logprob (incl. eos) / generated_len**penalty,
      generated_len excluding the forced prompt;
    - an utterance is done with K finished hypotheses whose worst beats the
      best candidate / generated_len**penalty; the loop stops when all are;
    - at max length, utterances not done fold their running beams into the
      finished set (finalize).
    The cross K/V stays at B rows, shared by each utterance's K hypotheses.
    Fused: the cache is never reordered; an ancestry map is
    gathered on the beam axis and fused_attn_beam reads each hypothesis'
    history through it. ASR_TPU_BEAM_REORDER=1 reorders the whole cache each
    step instead (the plain path always does). Suppress lists, the timestamp
    grammar, kv_int8, w_int8 and adapters behave as in greedy_decode."""
    st = None
    for st in beam_states(params, mel, cfg, forced_tokens, max_length, num_beams,
                          length_penalty, compute_dtype, suppress_tokens,
                          begin_suppress_tokens, timestamp_begin, no_timestamps_id,
                          kv_int8, w_int8, fused, adapters, quant):
        pass
    return _finalize(st, len(forced_tokens), length_penalty)


def make_decode_fn(cfg: WhisperConfig, forced_tokens: Sequence[int],
                   max_length: int = 225, num_beams: int = 1,
                   length_penalty: float = 1.0,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   suppress_tokens: Optional[Sequence[int]] = None,
                   begin_suppress_tokens: Optional[Sequence[int]] = None,
                   timestamp_begin: Optional[int] = None,
                   no_timestamps_id: Optional[int] = None,
                   kv_int8: bool = False, w_int8: bool = False,
                   fused: Optional[bool] = None,
                   quant: Optional[Q.QuantConfig] = None):
    """Decode entry of the transcription CLI, the trainer's eval and the
    offline evaluator: fn(params, mel, adapters=None) → (tokens, lengths),
    greedy, or beam search with num_beams > 1."""
    kw = dict(suppress_tokens=suppress_tokens,
              begin_suppress_tokens=begin_suppress_tokens,
              timestamp_begin=timestamp_begin, no_timestamps_id=no_timestamps_id,
              kv_int8=kv_int8, w_int8=w_int8, fused=fused, quant=quant)
    if num_beams <= 1:
        def fn(params, mel, adapters=None):
            return greedy_decode(params, mel, cfg, forced_tokens, max_length,
                                 compute_dtype, adapters=adapters, **kw)
    else:
        def fn(params, mel, adapters=None):
            return beam_decode(params, mel, cfg, forced_tokens, max_length,
                               num_beams, length_penalty, compute_dtype,
                               adapters=adapters, **kw)
    return fn

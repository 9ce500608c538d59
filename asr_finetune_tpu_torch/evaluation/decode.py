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
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import torch

from ..models import whisper as W
from ..models.configs import WhisperConfig
from ..ops import decoder_fused
from ..ops import quant as Q
from ..training.lora import merge_adapters

Params = dict

# whisper generation_config.max_initial_timestamp = 1.0 s at 0.02 s/token
MAX_INITIAL_TIMESTAMP_INDEX = 50


def _fused_head_dim_ok(cfg: WhisperConfig) -> bool:
    """The fused kernels reduce per 64-dim head (decoder_fused.HEAD_DIM)."""
    return cfg.d_model // cfg.decoder_heads == decoder_fused.HEAD_DIM


def _fused_default(cfg: WhisperConfig, device: torch.device) -> bool:
    """Fused kernels on a CUDA device with 64-dim heads. The JAX rule also
    asks for a single device, because a Pallas call cannot be partitioned
    over a mesh; a decode here runs on mel's one device however many cards
    the host has, so the device count does not enter."""
    return device.type == "cuda" and _fused_head_dim_ok(cfg)


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
                   compute_dtype: torch.dtype) -> Tuple[Params, int, int]:
    """Once per decode call: pad cross K/V on the source axis to a
    128-multiple (1500 → 1536 at large-v3, so the kernel masks s_valid on
    the main path) and flatten heads to the dense (L, B, S_pad, d) layout,
    int8 K/V as it is with its scales expanded to (L, B, d); pick a
    128-multiple cache length."""
    S_real = int(enc_out.shape[1])
    S_pad = _round_up(S_real, 128)

    def pad_dense(a, dtype):
        L, B, S, H, hd = a.shape
        out = torch.zeros((L, B, S_pad, H * hd), dtype=dtype, device=a.device)
        out[:, :, :S] = a.reshape(L, B, S, H * hd)
        return out

    def expand(scale):   # (L, B, 1, H, 1) → (L, B, d): index j has head j // hd
        hd = cross_kv["k_q8"].shape[-1]
        return scale[:, :, 0, :, 0].repeat_interleave(hd, dim=-1).contiguous()

    if "k_q8" in cross_kv:
        ckv = {"k_q8": pad_dense(cross_kv["k_q8"], torch.int8),
               "v_q8": pad_dense(cross_kv["v_q8"], torch.int8),
               "k_scale_d": expand(cross_kv["k_scale"]),
               "v_scale_d": expand(cross_kv["v_scale"])}
    else:
        ckv = {"k": pad_dense(cross_kv["k"], compute_dtype),
               "v": pad_dense(cross_kv["v"], compute_dtype)}
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
    dec = dict(params["decoder"], layers=Q.quantize_tree_int8(params["decoder"]["layers"]))
    return {**params, "decoder": dec}


def _resolve_fused(fused: Optional[bool], cfg: WhisperConfig,
                   device: torch.device) -> bool:
    """The routing rule: fused by default on a CUDA device with 64-dim
    heads, at any beam width (the JAX package routes more than 8 beams to
    its plain step; the CUDA kernels have no such bound); fused=True with a
    model it cannot serve raises."""
    if fused is None:
        return _fused_default(cfg, device)
    if fused and not _fused_head_dim_ok(cfg):
        raise ValueError(
            f"fused decode requires 64-dim heads, got "
            f"{cfg.d_model // cfg.decoder_heads} "
            f"(d_model={cfg.d_model}, heads={cfg.decoder_heads})")
    return fused


def _prepare_decode(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
                    max_length: int, rows: int, compute_dtype: torch.dtype,
                    kv_int8: bool, w_int8: bool, fused: bool,
                    adapters: Optional[Params], quant: Optional[Q.QuantConfig],
                    cross_group: int = 1):
    """Everything of a decode call before its token loop: adapters merged
    (fused), the encoder, the cross K/V at mel's B rows (int8 with kv_int8;
    laid out for the kernels when fused), the decoder weights cast (fused)
    and quantized (w_int8), a zeroed cache of `rows` rows. Returns
    (step(token, t, cache, ancestry=None) → (logits, cache), cache)."""
    if fused and adapters is not None:
        params, adapters = merge_adapters(params, adapters), None
    enc_out = W.encode(params, mel, cfg, compute_dtype, adapters=adapters,
                       quant=quant)
    cross_kv = W.precompute_cross_kv(params, enc_out, cfg, adapters, quant)
    if kv_int8:
        cross_kv = W.quantize_cross_kv(cross_kv)
    cache_len = max_length
    if fused:
        params = _cast_decoder_weights(params, compute_dtype)
        cross_kv, s_real, cache_len = _prepare_fused(
            enc_out, cross_kv, max_length, compute_dtype)
    if w_int8:
        params = _quantize_decoder_weights(params)
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
    adapters merged into the weights first."""
    device = mel.device
    B = mel.shape[0]
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

    with torch.no_grad():
        step, cache = _prepare_decode(params, mel, cfg, max_length, B,
                                      compute_dtype, kv_int8, w_int8, fused,
                                      adapters, quant)
        tokens = torch.full((B, max_length), eot, dtype=torch.long, device=device)
        tokens[:, 0] = forced[0]
        finished = torch.zeros((B,), dtype=torch.bool, device=device)
        last_ts = torch.zeros((B,), dtype=torch.long, device=device)
        t = 0
        while t < max_length - 1 and not bool(finished.all()):
            cur = tokens[:, t]
            logits, cache = step(cur, t, cache)
            if bias is not None:
                logits = logits + bias
            is_begin = (t + 1) == n_forced
            if begin_bias is not None and is_begin:
                logits = logits + begin_bias
            if with_ts:
                logits = _apply_timestamp_rules(
                    logits, cur, _timestamp_prev2(tokens, t, n_forced, timestamp_begin),
                    last_ts, is_begin, timestamp_begin, eot, no_ts_id)
            in_prefix = (t + 1) < n_forced
            if in_prefix:
                nxt = torch.full_like(cur, forced[t + 1])
            else:
                nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(finished, torch.full_like(nxt, eot), nxt)
            tokens[:, t + 1] = nxt
            if with_ts:
                last_ts = torch.where(nxt >= timestamp_begin, nxt, last_ts)
            if not in_prefix:
                finished |= nxt == eot
            t += 1

    before_eot = torch.cumsum((tokens == eot).long(), dim=1) == 0
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
        step, cache = _prepare_decode(params, mel, cfg, max_length, B * K,
                                      compute_dtype, kv_int8, w_int8, fused,
                                      adapters, quant, cross_group=K)
        st = BeamState(B, K, max_length, cache["k"].shape[2], forced[0], eot, device)
        own_rows = torch.arange(K, dtype=torch.int32, device=device)[None, :]
        rows = torch.arange(B, device=device)[:, None] * K
        rank_ok = torch.arange(2 * K, device=device)[None, :] < K
        yield st
        while st.t < max_length - 1 and not bool(st.done.all()):
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

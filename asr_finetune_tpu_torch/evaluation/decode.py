"""Greedy autoregressive decoding (counterpart of asr_finetune_tpu/evaluation/decode.py).

One Python loop over decode steps with a preallocated KV cache, early exit
once every row has emitted <|endoftext|> (the JAX `lax.while_loop`). The
forced prefix, `suppress_tokens`, `begin_suppress_tokens` and Whisper's
timestamp grammar behave as in the JAX greedy_decode.

Fused path: by default on a CUDA device when the decoder's head dim is 64,
each step runs the fused layer kernels (W.decode_step_fused) after
`_cast_decoder_weights` and `_prepare_fused`; LoRA adapters are merged into
the weights first (training/lora.merge_adapters), so over an int8 base the
kernels meet mixed int8/float weights. The plain W.decode_step runs
otherwise: on the CPU, for other head dims, or when the caller passes
fused=False; it takes the adapters unmerged. `quant` (ops/quant.QuantConfig)
is how the encoder and the cross K/V precompute multiply int8 weights.
w_int8 quantizes the decoder's float weights for the token loop.

Pending, and raising NotImplementedError rather than served some other way:
beam search (needs the fused_attn_beam kernel) and int8 cross-KV (kv_int8,
the k_scale/v_scale option of fused_attn).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
    the main path) and flatten heads to the dense (L, B, S_pad, d) layout;
    pick a 128-multiple cache length."""
    S_real = int(enc_out.shape[1])
    S_pad = _round_up(S_real, 128)

    def pad_dense(a):
        L, B, S, H, hd = a.shape
        out = torch.zeros((L, B, S_pad, H * hd), dtype=compute_dtype,
                          device=a.device)
        out[:, :, :S] = a.reshape(L, B, S, H * hd)
        return out

    ckv = {"k": pad_dense(cross_kv["k"]), "v": pad_dense(cross_kv["v"])}
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


def _check_pending(kv_int8: bool) -> None:
    if kv_int8:
        raise NotImplementedError("kv_int8: int8 cross-KV needs the int8 K/V "
                                  "option of the fused_attn kernel, not ported yet")


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
    _check_pending(kv_int8)
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
    if fused is None:
        fused = _fused_default(cfg, device)
    elif fused and not _fused_head_dim_ok(cfg):
        raise ValueError(
            f"fused decode requires 64-dim heads, got "
            f"{cfg.d_model // cfg.decoder_heads} "
            f"(d_model={cfg.d_model}, heads={cfg.decoder_heads})")

    with torch.no_grad():
        if fused and adapters is not None:
            params, adapters = merge_adapters(params, adapters), None
        enc_out = W.encode(params, mel, cfg, compute_dtype, adapters=adapters,
                           quant=quant)
        cross_kv = W.precompute_cross_kv(params, enc_out, cfg, adapters, quant)
        if fused:
            params = _cast_decoder_weights(params, compute_dtype)
            cross_kv, s_real, cache_len = _prepare_fused(
                enc_out, cross_kv, max_length, compute_dtype)
        else:
            cache_len = max_length
        if w_int8:
            params = _quantize_decoder_weights(params)
        cache = W.init_cache(cfg, B, cache_len, dtype=compute_dtype,
                             dense=fused, device=device)
        logits_w = W.tied_logits_weight(params["decoder"]["embed"], compute_dtype)

        tokens = torch.full((B, max_length), eot, dtype=torch.long, device=device)
        tokens[:, 0] = forced[0]
        finished = torch.zeros((B,), dtype=torch.bool, device=device)
        last_ts = torch.zeros((B,), dtype=torch.long, device=device)
        t = 0
        while t < max_length - 1 and not bool(finished.all()):
            cur = tokens[:, t]
            if fused:
                logits, cache = W.decode_step_fused(
                    params, cur, t, cache, cross_kv, cfg, s_real,
                    compute_dtype, logits_w)
            else:
                logits, cache = W.decode_step(
                    params, cur, t, cache, cross_kv, cfg, compute_dtype, logits_w,
                    adapters, quant)
            if bias is not None:
                logits = logits + bias
            is_begin = (t + 1) == n_forced
            if begin_bias is not None and is_begin:
                logits = logits + begin_bias
            if with_ts:
                # HF treats the penultimate token as a timestamp while fewer
                # than 2 tokens have been sampled, so the initial
                # segment-open timestamp is followed by text
                if t + 1 - n_forced < 2:
                    prev2 = torch.full_like(cur, timestamp_begin)
                else:
                    prev2 = tokens[:, max(t - 1, 0)]
                logits = _apply_timestamp_rules(
                    logits, cur, prev2, last_ts, is_begin, timestamp_begin,
                    eot, no_ts_id)
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


def beam_decode(*args, **kwargs):
    raise NotImplementedError("beam search needs the fused_attn_beam kernel "
                              "(ops/decoder_fused.py:548), not ported yet")


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
    """Decode entry of the transcription CLI and the trainer's eval:
    fn(params, mel, adapters=None) → (tokens, lengths). num_beams > 1
    raises (beam search is not ported)."""
    del length_penalty  # a beam-search parameter
    if num_beams > 1:
        beam_decode()
    _check_pending(kv_int8)   # raise now, not at the first batch

    def fn(params, mel, adapters=None):
        return greedy_decode(params, mel, cfg, forced_tokens, max_length,
                             compute_dtype, suppress_tokens,
                             begin_suppress_tokens, timestamp_begin,
                             no_timestamps_id, w_int8=w_int8, fused=fused,
                             adapters=adapters, quant=quant)
    return fn

"""Uni-MoE-2.0-Omni's speech-to-text path over explicit parameter trees.

HIT-TMG/Uni-MoE-2.0-Omni (config.json) feeds a Whisper-large encoder into a
Qwen2-style decoder-only language model whose every layer routes over
fixed, dynamic and null experts. The forward, for a batch of log-mel
windows and the transcript's token ids:

- audio: the encoder (models/whisper.encode, the Whisper kernels and
  remat), its 1,500 frames a 30 s window mean-pooled over non-overlapping
  groups of `audio_pool` (5: 300 tokens, the config's 10 a second;
  assumed, the config gives the rate and not the pooling), then a linear
  projector of the encoder's width to the LM's, with a bias (assumed);
- the sequence: the projected audio, then the embedded ids (the prefix
  <|im_start|>, the transcript, the end token), positions 0 … L−1;
- each layer: h = x + Attn(RMSNorm(x)), out = h + MoE(RMSNorm(h)).
  Attention: q/k/v with biases, o without, 1-D RoPE (θ = rope_theta, the
  rotate-half form; the three M-RoPE sections carry equal ids for audio
  and text, so they rotate as one), causal grouped-query attention of
  num_attention_heads over num_key_value_heads. It is PyTorch's
  scaled_dot_product_attention (causal, enable_gqa): at ≤ 500 positions
  it is about 1% of the step's work, beside the expert products;
- MoE(u) = Σ_fixed SwiGLU_f(u) + Σ_{i ∈ S} p_i · SwiGLU_i(u), SwiGLU(u) =
  W_down(silu(W_gate u) ⊙ W_up u): p = softmax(W_r u) in fp32 over the
  dynamic experts and the null ones (the null ones last); S is the
  shortest prefix of the routable experts sorted by p whose sum reaches
  mlp_dynamic_top_p, at most mlp_dynamic_top_k long; a null expert adds
  nothing. p is not renormalised over S (the dynamic-routing paper's
  form, assumed), the fixed experts add with weight 1 (assumed), and the
  gradient reaches p by plain autograd with S held fixed (assumed);
- a final RMSNorm; the untied head (vocab_size rows) is applied by the
  loss (ops/fused_ce.py) to the text positions only (`forward` returns
  their hidden states).

The router is fp32 (fp32_gate). Left out: the vision tower, the image and
speech generators, and the auxiliary balance loss (the router is frozen
under PEFT).

Routing on the card (`moe`): the gate, the selection, the permutation of
the taken slots into expert order and the weighted combination are torch
operations on the device; the layer reads its slots' counts by kind once
(the one host sync of a call: `count_syncs`), and each dynamic expert
with rows computes its SwiGLU on its contiguous rows. Spans `moe.route`
(gate, selection, permutation, the count read) and `moe.experts`
(products and combination); `moe_counters()` (registered with
utils/profiling.add_counters as "moe") counts layer calls (remat's
recomputes included), tokens, slots taken, null slots, dynamic-expert
rows computed and count syncs, as plain integers from that one read.

The int8 base (`init_params(int8=True)`, --load_in_8bit): every product of
the LM and the projector is int8 per output channel, held once, in the
K-major layout the W8A8 kernel reads: {"w_q8_nk" (…, d_out, d_in) int8,
"w_scale" (…, 1, d_out) fp32}, no (d_in, d_out) copy (at this model's
25 B parameters a second copy would take 25.7 GB). The product passes the
view w_nk.t() as w_q8 (ops/quant.int8_matmul), whose straight-through
backward dequantizes that view. The encoder's weights are Whisper's and
keep both layouts (its decoder kernels are not used here). The
embeddings and the head stay bf16, the router fp32. The weights are made
one layer at a time, so a random 25 B-parameter model is never whole in
a float type on the card.

Parameter tree: {"encoder", "encoder_pos"} (Whisper's), "projector" {w,
b}, "lm" {"embed" (V, d), "head" (V, d), "norm" {"scale"}, "layers":
{"ln1", "ln2" {"scale" (L, d)}, "attn" {q, k, v, o}, "router" {"w" (L,
d, experts)}, "fixed" / "dynamic" {gate, up, down} stacked (L, E, …)}}.
A float projection is {"w" (…, d_in, d_out)} as in Whisper's trees.
Adapters (training/lora.py): {"encoder": {q, v}, "lm": {q, v}}.

Not ported for this model: the serving path (a decoder-only greedy loop
with a GQA KV cache), so greedy WER, cli.transcribe and cli.evaluate
raise; and tensor parallelism (--tp > 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops import quant as Q
from ..utils import profiling
from . import whisper as W
from .configs import UniMoEConfig
from .tokenizer import ByteFallbackTokenizer, SpecialTokens

Params = Dict[str, Any]
NK = Q.KMAJOR_KEY
NO_DECODE = ("Uni-MoE-2.0-Omni has no serving path in the port yet (a decoder-only greedy "
             "loop with a GQA KV cache): greedy WER, cli.transcribe and cli.evaluate are "
             "not available; train with --skip_wer_eval")


def is_unimoe(cfg) -> bool:
    return isinstance(cfg, UniMoEConfig)


# ---------------------------------------------------------------------------
# counters (utils/profiling.add_counters)
# ---------------------------------------------------------------------------

_COUNTS = dict.fromkeys(("layer_calls", "tokens", "slots", "null_slots", "expert_rows",
                         "count_syncs"), 0)


def moe_counters() -> Dict[str, int]:
    """The expert layers' counts since the process started: layer calls
    (remat's recomputes included), tokens routed, slots taken, null slots,
    dynamic-expert rows computed, count syncs."""
    return dict(_COUNTS)


profiling.add_counters("moe", moe_counters)


# ---------------------------------------------------------------------------
# tokenizer and initialization
# ---------------------------------------------------------------------------

class ImTokenizer(ByteFallbackTokenizer):
    """The byte-level fallback tokenizer (no vocabulary files: text bytes are
    ids 0-255, assumed) with the chat template's <|im_start|> as the only
    prefix token and <|im_end|> as the end."""

    def prefix_tokens(self, language: str = "de", task: str = "transcribe",
                      predict_timestamps: bool = False):
        return [self.special.sot]


def tokenizer(cfg: UniMoEConfig) -> ImTokenizer:
    sot, eot = cfg.sot_token_id, cfg.eos_token_id
    return ImTokenizer(SpecialTokens(eot=eot, sot=sot, first_language=sot, n_languages=0,
                                     translate=sot, transcribe=sot, no_timestamps=sot,
                                     timestamp_begin=eot + 1))


def _lm_leaves(cfg: UniMoEConfig):
    """(path, experts or None, d_in, d_out, bias) of every stacked LM
    product, in the order init_params draws them."""
    d, kv = cfg.hidden_size, cfg.num_key_value_heads * cfg.head_dim
    Ef, Fs = cfg.mlp_fixed_expert_num, cfg.shared_intermediate_size
    Ed, Fd = cfg.mlp_dynamic_expert_num, cfg.dynamic_intermediate_size
    return [("attn/q", None, d, d, True), ("attn/k", None, d, kv, True),
            ("attn/v", None, d, kv, True), ("attn/o", None, d, d, False),
            ("fixed/gate", Ef, d, Fs, False), ("fixed/up", Ef, d, Fs, False),
            ("fixed/down", Ef, Fs, d, False),
            ("dynamic/gate", Ed, d, Fd, False), ("dynamic/up", Ed, d, Fd, False),
            ("dynamic/down", Ed, Fd, d, False)]


def _put(tree: Params, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def init_params(cfg: UniMoEConfig, seed: int = 0, device="cpu", int8: bool = False) -> Params:
    """Random init (Whisper's law: uniform ±1/sqrt(d_in) products, zero
    biases, unit norm scales, N(0, 0.02) embeddings and head; the router
    uniform ±1/sqrt(d)), the encoder by models/whisper.init_params. Each
    stacked LM product is drawn one layer at a time (…, d_in, d_out); with
    int8 each layer is quantized as it is drawn into the one K-major int8
    copy (module docstring) and the embeddings and head are bf16, so the
    same seed gives the int8 form of the float weights."""
    enc_cfg = dataclasses.replace(cfg.encoder, decoder_layers=0, vocab_size=1,
                                  max_target_positions=1)
    whisper = W.init_params(enc_cfg, seed=seed, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 2)
    d, L, e = cfg.hidden_size, cfg.num_hidden_layers, cfg.whisper_hidden_size

    def uniform(d_in, *shape):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) / math.sqrt(d_in)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def proj(lead, d_in, d_out, layers):
        """A product of `layers` layers (None: one, unstacked), drawn layer
        by layer."""
        n = 1 if layers is None else layers
        pre = () if layers is None else (layers,)
        if int8:
            q = torch.empty(pre + lead + (d_out, d_in), dtype=torch.int8, device=device)
            s = torch.empty(pre + lead + (1, d_out), dtype=torch.float32, device=device)
            for l in range(n):
                part = Q.quantize_weight(uniform(d_in, *lead, d_in, d_out))
                dst = (q, s) if layers is None else (q[l], s[l])
                dst[0].copy_(part[Q.QUANT_KEY].transpose(-1, -2))
                dst[1].copy_(part[Q.SCALE_KEY])
            return {NK: q, Q.SCALE_KEY: s}
        w = torch.empty(pre + lead + (d_in, d_out), device=device)
        for l in range(n):
            (w if layers is None else w[l]).copy_(uniform(d_in, *lead, d_in, d_out))
        return {"w": w}

    table = torch.bfloat16 if int8 else torch.float32
    layers: Params = {"ln1": {"scale": torch.ones((L, d), device=device)},
                      "ln2": {"scale": torch.ones((L, d), device=device)},
                      "router": {"w": uniform(d, L, d, cfg.mlp_dynamic_expert_num
                                              + cfg.mlp_dynamic_null_expert_num)}}
    for path, experts, d_in, d_out, bias in _lm_leaves(cfg):
        node = proj(() if experts is None else (experts,), d_in, d_out, L)
        if bias:
            node["b"] = zeros(L, d_out)
        _put(layers, path, node)
    projector = dict(proj((), e, d, None), b=zeros(d))
    lm = {"embed": (torch.randn((cfg.vocab_size, d), generator=g, device=device) * 0.02
                    ).to(table),
          "head": (torch.randn((cfg.vocab_size, d), generator=g, device=device) * 0.02
                   ).to(table),
          "norm": {"scale": torch.ones((d,), device=device)}, "layers": layers}
    return {"encoder": whisper["encoder"], "encoder_pos": whisper["encoder_pos"],
            "projector": projector, "lm": lm}


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics, rounded once to x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope_tables(length: int, head_dim: int, theta: float, device):
    """(cos, sin), each (length, head_dim) fp32: positions 0 … length−1 over
    the frequencies theta^(−2i / head_dim), the halves repeated."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
                          / head_dim)
    f = torch.arange(length, dtype=torch.float64, device=device)[:, None] * inv[None]
    emb = torch.cat([f, f], dim=-1)
    return emb.cos().float(), emb.sin().float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, hd) rotated by position (rotate-half form), in fp32,
    rounded once to x's dtype."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (x32 * cos[:, None] + rot * sin[:, None]).to(x.dtype)


def _base(x: torch.Tensor, p: Params, quant: Optional[Q.QuantConfig]) -> torch.Tensor:
    """x @ W of one projection: a float "w" cast to x's dtype; a K-major
    int8 weight as W8A8 under quant.matmul (the kernel reads w_nk, the
    plain version and the backward its view w_nk.t()), else dequantized."""
    if NK in p:
        w_nk, s = p[NK], p[Q.SCALE_KEY]
        if quant is not None and quant.matmul:
            return Q.int8_matmul(x, w_nk.t(), s, quant, w_nk)
        return torch.matmul(x, w_nk.t().to(x.dtype) * s.to(x.dtype))
    return torch.matmul(x, p["w"].to(x.dtype))


def _dense(x, p, quant, lora=None, dropout=None, site=""):
    return W._complete(_base(x, p, quant), x, p, lora, dropout, site)


def _expert(ex: Params, e: int) -> Params:
    return {n: {k: v[e] for k, v in ex[n].items()} for n in ("gate", "up", "down")}


def swiglu(x: torch.Tensor, ex: Params, quant: Optional[Q.QuantConfig]) -> torch.Tensor:
    """W_down(silu(W_gate x) ⊙ W_up x) of one expert."""
    return _base(F.silu(_base(x, ex["gate"], quant)) * _base(x, ex["up"], quant),
                 ex["down"], quant)


# ---------------------------------------------------------------------------
# the expert layer
# ---------------------------------------------------------------------------

def route(u2: torch.Tensor, router_w: torch.Tensor, cfg: UniMoEConfig):
    """(p_k (N, k) fp32, kind (N·k,) long) of rows u2 (N, d): the top-k
    probabilities of the fp32 gate, and each slot's kind, its dynamic
    expert, n_dyn for a null expert, n_dyn + 1 where the slot is not taken
    (the slots before it already hold top_p)."""
    k, n_dyn = cfg.mlp_dynamic_top_k, cfg.mlp_dynamic_expert_num
    probs = torch.softmax(torch.matmul(u2.float(), router_w.float()), dim=-1)
    p_sorted, idx = probs.sort(dim=-1, descending=True, stable=True)
    p_k, e_k = p_sorted[:, :k], idx[:, :k]
    before = torch.cat([torch.zeros_like(p_k[:, :1]), p_k.cumsum(dim=-1)[:, :-1]], dim=-1)
    kind = torch.where(before < cfg.mlp_dynamic_top_p, torch.clamp(e_k, max=n_dyn),
                       torch.full_like(e_k, n_dyn + 1))
    return p_k, kind.reshape(-1)


def moe(u: torch.Tensor, lp: Params, cfg: UniMoEConfig,
        quant: Optional[Q.QuantConfig] = None) -> torch.Tensor:
    """MoE(u) of one layer (module docstring), u (B, T, d) in the compute
    dtype; the experts' outputs are combined in fp32 and rounded once."""
    shape, d = u.shape, u.shape[-1]
    u2 = u.reshape(-1, d)
    N, k, n_dyn = u2.shape[0], cfg.mlp_dynamic_top_k, cfg.mlp_dynamic_expert_num
    with profiling.span("moe.route"):
        p_k, kind = route(u2, lp["router"]["w"], cfg)
        order = torch.argsort(kind, stable=True)
        counts = torch.bincount(kind, minlength=n_dyn + 2).tolist()   # the one sync
        rows = sum(counts[:n_dyn])
        # counted here: remat's recompute may stop once the tensors it needs are back
        for name, v in (("layer_calls", 1), ("tokens", N), ("slots", N * k - counts[-1]),
                        ("null_slots", counts[n_dyn]), ("expert_rows", rows),
                        ("count_syncs", 1)):
            _COUNTS[name] += v
    with profiling.span("moe.experts"):
        acc = None
        for f in range(cfg.mlp_fixed_expert_num):
            y = swiglu(u2, _expert(lp["fixed"], f), quant).float()
            acc = y if acc is None else acc + y
        if rows:
            sel = order[:rows]
            xs = u2[torch.div(sel, k, rounding_mode="floor")]
            ys, off = [], 0
            for e in range(n_dyn):
                if counts[e]:
                    ys.append(swiglu(xs[off: off + counts[e]], _expert(lp["dynamic"], e),
                                     quant).float())
                off += counts[e]
            y = torch.cat(ys) * p_k.reshape(-1)[sel][:, None]
            slots = torch.zeros((N * k, d), dtype=torch.float32, device=u.device)
            dyn = slots.index_copy(0, sel, y).view(N, k, d).sum(dim=1)
            acc = dyn if acc is None else acc + dyn
    if acc is None:
        return torch.zeros_like(u)
    return acc.to(u.dtype).reshape(shape)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer(x, lp, la, cos, sin, cfg: UniMoEConfig, quant, dropout, site: str):
    """One LM layer: x + Attn(RMSNorm(x)), then + MoE(RMSNorm(·))."""
    B, T, d = x.shape
    hd, la = cfg.head_dim, la or {}
    at = lp["attn"]
    h = rms_norm(x, lp["ln1"]["scale"], cfg.rms_norm_eps)
    q = _dense(h, at["q"], quant, la.get("q"), dropout, f"{site}/q")
    k = _dense(h, at["k"], quant)
    v = _dense(h, at["v"], quant, la.get("v"), dropout, f"{site}/v")
    q = apply_rope(q.view(B, T, -1, hd), cos, sin).transpose(1, 2)
    k = apply_rope(k.view(B, T, -1, hd), cos, sin).transpose(1, 2)
    v = v.view(B, T, -1, hd).transpose(1, 2)
    # PyTorch's attention, not a kernel of the port: ~1% of the step's work
    # at these lengths (module docstring)
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    x = x + _dense(o.transpose(1, 2).reshape(B, T, d), at["o"], quant)
    return x + moe(rms_norm(x, lp["ln2"]["scale"], cfg.rms_norm_eps), lp, cfg, quant)


def forward(params: Params, mel: torch.Tensor, tokens: torch.Tensor, cfg: UniMoEConfig,
            compute_dtype: torch.dtype = torch.bfloat16, remat: bool = False,
            attn_impl: str = "auto", adapters: Optional[Params] = None,
            dropout: Optional[W.LoraDropout] = None,
            quant: Optional[Q.QuantConfig] = None, fused_qkv: bool = True) -> torch.Tensor:
    """mel (B, frames, n_mels), tokens (B, T) → the final-normed hidden
    states of the T text positions (B, T, d), which the head reads. remat:
    each encoder half-block (models/whisper.py's save points) and each LM
    layer is recomputed in the backward."""
    enc = W.encode(params, mel, cfg.encoder, compute_dtype, remat, attn_impl, adapters,
                   dropout, quant, fused_qkv)
    B, S, e = enc.shape
    pooled = enc.float().reshape(B, S // cfg.audio_pool, cfg.audio_pool, e).mean(dim=2)
    audio = _dense(pooled.to(compute_dtype), params["projector"], quant)
    lm = params["lm"]
    x = torch.cat([audio, lm["embed"][tokens].to(compute_dtype)], dim=1)
    cos, sin = rope_tables(x.shape[1], cfg.head_dim, cfg.rope_theta, x.device)
    L = cfg.num_hidden_layers
    las = W._layer_adapters(adapters, "lm", L)
    for l, lp in enumerate(W._unbind_layers(lm["layers"], L)):
        x = W._maybe_remat(_layer, remat, x, lp, las[l], cos, sin, cfg, quant, dropout,
                           f"lm/{l}")
    x = rms_norm(x, lm["norm"]["scale"], cfg.rms_norm_eps)
    return x[:, audio.shape[1]:]


def no_decode(*args, **kwargs):
    """The decode function the trainer holds for this model: it raises."""
    raise NotImplementedError(NO_DECODE)

"""Whisper encoder-decoder in PyTorch over explicit parameter trees.

Counterpart of asr_finetune_tpu/models/whisper.py: the encoder, the
teacher-forced decoder and full forward with the loss (training), the
cross-attention K/V precompute and the two per-token decode steps (the
plain reference step and the fused-kernel step). Parameters are a nested
dict of tensors with the JAX tree's keys and layouts: per-layer weights
stacked on a leading axis ((L, d_in, d_out), biases (L, d)), the decode
cache dense (L, B, T, d). The layer loops are Python loops over views of
the stacked tensors (`torch.unbind`, so a layer's gradients reach the
stacked leaf through one stack); the fused kernels take the full stacked
tensors plus the layer index and read layer l in place.

Numerics follow the JAX functions: matmuls in the compute dtype with the
weights cast at use (`dense`; free after `cast_matmul_weights_` has cast
them once for serving; training keeps fp32 masters and casts at every use,
as the JAX train step does), layer-norm statistics in fp32, the conv stem in
fp32, exact-erf GELU, logits in fp32 from compute-dtype operands.

Rematerialisation (`remat=True`) is `torch.utils.checkpoint` (non-reentrant)
per half-block: the saved points are each layer's input and the residual
stream between its half-blocks, the JAX `blk_mid` points
(ASR_TPU_REMAT_SAVE=mid). The JAX package's extra named save points
(`enc_qkv`, `enc_mlp_h`, `dec_*`) are not ported; they change memory and
time, never numbers.

PEFT (training/lora.py): `adapters`, a tree beside the frozen base, adds a
low-rank delta to every adapted q/v projection (`dense`); lora dropout on
the adapter input is `LoraDropout`. A frozen base may be int8
({"w_q8", "w_scale"}, ops/quant.py): `dense` dequantizes it into the
compute dtype, or, when the `quant` config asks for it (--int8_matmul),
computes the product as W8A8 through the kernel (ops/quant.int8_matmul).

The fused-qkv encoder path (opt-in, ASR_TPU_FUSED_QKV; `_fused_qkv_ok`)
runs each encoder layer's q/k/v as one wide (d, 3d) product whose (B, T,
3d) output feeds the attention kernel directly (`_mha_fused_qkv`,
ops/encoder_attention.dense_attention_qkv), as the JAX `encode` does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .configs import WhisperConfig
from ..ops import decoder_fused as DF
from ..ops import encoder_attention as EA
from ..ops import quant as Q
from ..ops.attention import attention as _attention_dispatch
from ..ops.attention import xla_attention

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoid table (sin | cos concatenated on channels)."""
    assert channels % 2 == 0
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_params(cfg: WhisperConfig, seed: int = 0, device="cpu") -> Params:
    """Random init in Whisper's layout (the JAX init_params' distributions:
    uniform ±1/sqrt(d_in) weights, zero biases, unit LN scales, N(0, 0.02)
    embeddings). A torch.Generator on `device` draws the numbers, so a
    large model initialises on the card; the values differ from JAX's."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    L_e, L_d, d, ff = cfg.encoder_layers, cfg.decoder_layers, cfg.d_model, cfg.d_ff

    def uniform(d_in, *shape):
        return ((torch.rand(shape, generator=g, device=device) * 2 - 1)
                / math.sqrt(d_in))

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ln(L=None):
        shape = (d,) if L is None else (L, d)
        return {"scale": torch.ones(shape, device=device), "bias": zeros(*shape)}

    def attn(L):
        return {"q": {"w": uniform(d, L, d, d), "b": zeros(L, d)},
                "k": {"w": uniform(d, L, d, d)},       # no bias, as in Whisper
                "v": {"w": uniform(d, L, d, d), "b": zeros(L, d)},
                "o": {"w": uniform(d, L, d, d), "b": zeros(L, d)}}

    def mlp(L):
        return {"fc1": {"w": uniform(d, L, d, ff), "b": zeros(L, ff)},
                "fc2": {"w": uniform(ff, L, ff, d), "b": zeros(L, d)}}

    n_mels = cfg.num_mel_bins
    encoder = {
        "conv1": {"w": uniform(3 * n_mels, 3, n_mels, d), "b": zeros(d)},
        "conv2": {"w": uniform(3 * d, 3, d, d), "b": zeros(d)},
        "layers": {"ln1": ln(L_e), "attn": attn(L_e), "ln2": ln(L_e),
                   "mlp": mlp(L_e)},
        "ln_post": ln(),
    }
    decoder = {
        "embed": torch.randn((cfg.vocab_size, d), generator=g, device=device) * 0.02,
        "pos": torch.randn((cfg.max_target_positions, d), generator=g,
                           device=device) * 0.02,
        "layers": {"ln1": ln(L_d), "self_attn": attn(L_d), "ln2": ln(L_d),
                   "cross_attn": attn(L_d), "ln3": ln(L_d), "mlp": mlp(L_d)},
        "ln_post": ln(),
    }
    return {"encoder": encoder, "decoder": decoder,
            "encoder_pos": torch.from_numpy(sinusoidal_positions(
                cfg.max_source_positions, d)).to(device)}


def cast_matmul_weights_(params: Params, dtype: torch.dtype) -> Params:
    """Cast, in place, every weight that is only ever used in `dtype`: the
    layers' projections and biases, the token and position embeddings. The
    layer norms and the fp32 conv stem stay as they are. Each old tensor is
    released as its cast replaces it, so the peak is one leaf above the
    model. What the model computes in `dtype` is unchanged: `dense`,
    `_embed` and `tied_logits_weight` cast the same values at use."""
    def cast(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                if not k.startswith("ln"):
                    cast(v)
            else:
                tree[k] = v.to(dtype)

    cast(params["encoder"]["layers"])
    dec = params["decoder"]
    cast(dec["layers"])
    dec["embed"], dec["pos"] = dec["embed"].to(dtype), dec["pos"].to(dtype)
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _layer(tree: Params, l: int) -> Params:
    """Layer l of a stacked subtree: the same dict with every tensor
    replaced by its view [l]."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def _unbind_layers(tree: Params, n: int) -> list:
    """The n layers of a stacked subtree as a list of per-layer dicts of
    views. One unbind per leaf: in a backward the layers' gradients are
    stacked into the leaf once, where per-layer indexing would add a
    full-size zero-padded gradient per layer."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = (_unbind_layers(v, n) if isinstance(v, dict)
                 else torch.unbind(v, 0))
        for l in range(n):
            out[l][k] = parts[l]
    return out


def _maybe_remat(fn, remat: bool, *args):
    """fn(*args), under non-reentrant activation checkpointing when remat is
    on and autograd is recording: only args are kept for the backward, which
    runs fn again to rebuild what it needs."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: fp32, unless already wider."""
    return torch.promote_types(dtype, torch.float32)


def layer_norm(x: torch.Tensor, ln: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics regardless of compute dtype."""
    acc = _acc(x.dtype)
    x32 = x.to(acc)
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * ln["scale"].to(acc) + ln["bias"].to(acc)
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LoraDropout:
    """lora_dropout on the adapter input (peft semantics: the frozen base
    path never sees it). Each site (a projection of a layer) draws its mask
    from a torch.Generator seeded by (seed, step, site), so a mask repeats
    for the same seed and step, differs across steps and sites, and the
    remat recompute redraws exactly the mask of the forward. The JAX
    package draws from lax.rng_bit_generator, whose bits depend on the
    backend: the two masks have one law, not one stream."""
    rate: float
    seed: int
    step: int = 0

    def __call__(self, x: torch.Tensor, site: str) -> torch.Tensor:
        if self.rate <= 0.0:
            return x
        digest = hashlib.blake2b(f"{self.seed}/{self.step}/{site}".encode(),
                                 digest_size=8).digest()
        g = torch.Generator(device=x.device)
        g.manual_seed(int.from_bytes(digest, "little") >> 1)
        u = torch.rand(x.shape, generator=g, device=x.device)
        return torch.where(u >= self.rate, x / (1.0 - self.rate),
                           torch.zeros_like(x))


def _lora_delta(x: torch.Tensor, lora: Params, dropout: Optional[LoraDropout],
                site: str) -> torch.Tensor:
    """scaling · ((drop(x) @ a) · e) @ b, in x's dtype (one layer's a (d_in,
    r), e (1, r), b (r, d_out), scaling ())."""
    xa = x if dropout is None else dropout(x, site)
    y = torch.matmul(torch.matmul(xa, lora["a"].to(x.dtype)) * lora["e"].to(x.dtype),
                     lora["b"].to(x.dtype))
    return y * lora["scaling"].to(x.dtype)


def _base_matmul(x: torch.Tensor, p: Params,
                 quant: Optional[Q.QuantConfig] = None) -> torch.Tensor:
    """x @ W of one projection, the weight cast to x's dtype at use; an int8
    weight dequantized into x's dtype, or with quant.matmul multiplied as
    W8A8 (ops/quant.int8_matmul). The JAX `_base_matmul_multi` (:204) over
    one (possibly fused) projection."""
    if Q.QUANT_KEY in p:
        if quant is not None and quant.matmul:
            return Q.int8_matmul(x, p[Q.QUANT_KEY], p[Q.SCALE_KEY], quant)
        return torch.matmul(x, Q.dequantize_weight(p, x.dtype))
    return torch.matmul(x, p["w"].to(x.dtype))


def dense(x: torch.Tensor, p: Params, lora: Optional[Params] = None,
          dropout: Optional[LoraDropout] = None, site: str = "",
          quant: Optional[Q.QuantConfig] = None) -> torch.Tensor:
    """x @ W (+ adapter delta) (+ b), the weight and bias cast to x's dtype at
    use (`_base_matmul`)."""
    y = _base_matmul(x, p, quant)
    if lora is not None:
        y = y + _lora_delta(x, lora, dropout, site)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, hd = x.shape
    return x.reshape(b, t, h * hd)


def mha(x: torch.Tensor, kv_src: torch.Tensor, p: Params, heads: int,
        mask: Optional[torch.Tensor] = None,
        causal: bool = False, impl: str = "auto",
        lora: Optional[Params] = None, dropout: Optional[LoraDropout] = None,
        site: str = "", quant: Optional[Q.QuantConfig] = None) -> torch.Tensor:
    """Full (non-incremental) multi-head attention; with impl "auto",
    non-causal unmasked calls run the encoder-attention kernel
    (ops/attention.attention). lora: this layer's {"q", "v"} adapters."""
    lq = lora.get("q") if lora else None
    lv = lora.get("v") if lora else None
    q = _split_heads(dense(x, p["q"], lq, dropout, site + "/q", quant), heads)
    k = _split_heads(dense(kv_src, p["k"], quant=quant), heads)
    v = _split_heads(dense(kv_src, p["v"], lv, dropout, site + "/v", quant), heads)
    out = _attention_dispatch(q, k, v, mask, causal=causal, impl=impl)
    return dense(_merge_heads(out), p["o"], quant=quant)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)   # exact erf form, as jax.nn.gelu(approximate=False)


def mlp_block(x: torch.Tensor, p: Params,
              quant: Optional[Q.QuantConfig] = None) -> torch.Tensor:
    return dense(_gelu(dense(x, p["fc1"], quant=quant)), p["fc2"], quant=quant)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """(B, T, C) conv, kernel 3, padding 1, w (3, C_in, C_out), in fp32 (the
    stem is <0.5% of the encoder's FLOPs; on the card TF32 is off)."""
    acc = _acc(x.dtype)
    y = F.conv1d(x.to(acc).transpose(1, 2), w.to(acc).permute(2, 1, 0),
                 stride=stride, padding=1)
    return y.transpose(1, 2) + b.to(acc)


def _fuse_qkv_weights(attn: Params) -> Params:
    """The stacked q/k/v projections as one wide (L, d, 3d) projection (the
    JAX function of the same name, :376): {"w"}, or {"w_q8", "w_scale"}
    with the scales concatenated on the output axis; k has no bias in
    Whisper, so its slot in the fused bias is zeros. Gradients reach the
    separate q/k/v leaves through the concatenation. A mix of int8 and float
    projections cannot be one product and raises (`encode` never passes one:
    see `_qkv_mixed`)."""
    ps = [attn[n] for n in "qkv"]
    fused: Params = {}
    if all(Q.QUANT_KEY in p for p in ps):
        fused[Q.QUANT_KEY] = torch.cat([p[Q.QUANT_KEY] for p in ps], dim=-1)
        fused[Q.SCALE_KEY] = torch.cat([p[Q.SCALE_KEY] for p in ps], dim=-1)
    elif _qkv_mixed(attn):
        raise ValueError("mixed int8/float q/k/v projections cannot be qkv-fused")
    else:
        fused["w"] = torch.cat([p["w"] for p in ps], dim=-1)
    if any("b" in p for p in ps):
        ref = next(p["b"] for p in ps if "b" in p)
        fused["b"] = torch.cat([p["b"] if "b" in p else torch.zeros_like(ref)
                                for p in ps], dim=-1)
    return fused


def _qkv_mixed(attn: Params) -> bool:
    """Some but not all of q/k/v int8: the merged PEFT base of an eval
    decode, where merging the adapters made q and v float."""
    return len({Q.QUANT_KEY in attn[n] for n in "qkv"}) > 1


def _lora_delta_qkv(x: torch.Tensor, lora: Params, d: int,
                    dropout: Optional[LoraDropout], site: str) -> torch.Tensor:
    """The q and v adapters' deltas in the fused (B, T, 3d) layout as one
    block product, the JAX fused form (:406): [drop(x)@a_q·e_q |
    drop(x)@a_v·e_v] @ B', where B' holds b_q·scaling in columns [0, d) and
    b_v·scaling in [2d, 3d), zeros elsewhere. The scaling is folded into B'
    before the product, so this rounds as the JAX fused path does (the
    unfused `_lora_delta` scales after it). Dropout draws each adapter's
    mask at the unfused path's site (site + "/q", site + "/v")."""
    xs, bs = [], []
    for name, off in (("q", 0), ("v", 2)):
        la = lora.get(name)
        if la is None:
            continue
        b = (la["b"] * la["scaling"]).to(x.dtype)
        xa = x if dropout is None else dropout(x, f"{site}/{name}")
        xs.append(torch.matmul(xa, la["a"].to(x.dtype)) * la["e"].to(x.dtype))
        r = b.shape[0]
        bs.append(torch.cat([b.new_zeros((r, off * d)), b,
                             b.new_zeros((r, (2 - off) * d))], dim=1))
    if len(xs) == 1:
        return torch.matmul(xs[0], bs[0])
    return torch.matmul(torch.cat(xs, dim=-1), torch.cat(bs, dim=0))


def _mha_fused_qkv(x: torch.Tensor, p: Params, fw: Params, heads: int,
                   lora: Optional[Params] = None,
                   dropout: Optional[LoraDropout] = None, site: str = "",
                   quant: Optional[Q.QuantConfig] = None) -> torch.Tensor:
    """Encoder self-attention with q/k/v as one wide product (the JAX
    function of the same name, :434): x @ W_qkv (float, dequantized int8 or
    W8A8), the q/v adapter deltas in the same layout, the fused bias, then
    the attention kernel straight on the (B, T, 3d) buffer
    (ops/encoder_attention.dense_attention_qkv) and the output projection."""
    d = x.shape[-1]
    y = _base_matmul(x, fw, quant)
    if lora and ("q" in lora or "v" in lora):
        y = y + _lora_delta_qkv(x, lora, d, dropout, site)
    if "b" in fw:
        y = y + fw["b"].to(x.dtype)
    out = EA.dense_attention_qkv(y, d // heads)
    return dense(out, p["o"], quant=quant)


def _fused_qkv_ok(cfg: WhisperConfig, T: int, impl: str,
                  device: torch.device) -> bool:
    """The gate of the fused-qkv encoder path (the JAX function of the same
    name, :465), opt-in through ASR_TPU_FUSED_QKV, read at every call:
    unset or 0 off; 1 on where impl is "auto", yielding to an explicit
    impl "xla"; force on whatever impl says; auto on where the dispatch
    runs the encoder-attention kernel, impl "auto" on a CUDA device. Never
    at a shape the kernels cannot take (EA.fused_qkv_supported)."""
    mode = os.environ.get("ASR_TPU_FUSED_QKV", "0").lower()
    if mode in ("0", "false", "no", "off"):
        return False
    hd = cfg.d_model // cfg.encoder_heads
    if cfg.encoder_heads * hd != cfg.d_model \
            or not EA.fused_qkv_supported(cfg.encoder_heads, hd, T):
        return False
    if impl != "auto":
        return mode == "force"
    if mode in ("1", "true", "yes", "on", "force"):
        return True
    return torch.device(device).type == "cuda"


def _enc_attn_half(x, lp, la, heads: int, impl: str, dropout, site: str, quant):
    h = layer_norm(x, lp["ln1"])
    if "attn_qkv" in lp:
        a = _mha_fused_qkv(h, lp["attn"], lp["attn_qkv"], heads, la, dropout,
                           site, quant)
    else:
        a = mha(h, h, lp["attn"], heads, impl=impl, lora=la, dropout=dropout,
                site=site, quant=quant)
    return x + a                                                    # blk_mid


def _mlp_half(x, ln, mlp, quant):
    return x + mlp_block(layer_norm(x, ln), mlp, quant)


def _layer_adapters(adapters: Optional[Params], part: str, n: int) -> list:
    """The n per-layer adapter dicts of adapters[part], or n Nones."""
    tree = adapters.get(part) if adapters else None
    return _unbind_layers(tree, n) if tree else [None] * n


def encode(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
           compute_dtype: torch.dtype = torch.bfloat16,
           remat: bool = False, attn_impl: str = "auto",
           adapters: Optional[Params] = None,
           dropout: Optional[LoraDropout] = None,
           quant: Optional[Q.QuantConfig] = None,
           fused_qkv: bool = True) -> torch.Tensor:
    """mel (B, frames, n_mels) → encoder states (B, frames//2, d_model).
    remat: recompute each half-block in the backward (see the module
    docstring); attn_impl: "auto" (the attention kernel) or "xla";
    adapters["encoder"]: q/v adapters of the self-attention.

    Where `_fused_qkv_ok` engages (ASR_TPU_FUSED_QKV) and fused_qkv allows
    it, every layer's q/k/v run as one wide product into the fused-qkv
    attention kernel: the wide weights are built once per call, outside the
    layer loop, and the per-layer tree keeps only o. A q/k/v mix of int8
    and float (a merged PEFT base) takes the three projections for the call,
    where the JAX function raises. fused_qkv=False keeps the three
    projections whatever the environment says (the outlier calibration)."""
    enc = params["encoder"]
    x = _gelu(_conv1d(mel, enc["conv1"]["w"], enc["conv1"]["b"], 1))
    x = _gelu(_conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], 2))
    x = x.to(compute_dtype)
    x = x + params["encoder_pos"][: x.shape[1]].to(compute_dtype)[None]
    L = cfg.encoder_layers
    las = _layer_adapters(adapters, "encoder", L)
    layers = enc["layers"]
    if fused_qkv and not _qkv_mixed(layers["attn"]) \
            and _fused_qkv_ok(cfg, x.shape[1], attn_impl, x.device):
        layers = dict(layers, attn_qkv=_fuse_qkv_weights(layers["attn"]),
                      attn={"o": layers["attn"]["o"]})
    for l, lp in enumerate(_unbind_layers(layers, L)):
        x = _maybe_remat(_enc_attn_half, remat, x, lp, las[l], cfg.encoder_heads,
                         attn_impl, dropout, f"enc/{l}", quant)
        x = _maybe_remat(_mlp_half, remat, x, lp["ln2"], lp["mlp"], quant)
    return layer_norm(x, enc["ln_post"])


# ---------------------------------------------------------------------------
# decoder (teacher-forced / full sequence)
# ---------------------------------------------------------------------------

def _dec_self_half(x, lp, la, heads: int, impl: str, dropout, site: str, quant):
    h = layer_norm(x, lp["ln1"])
    return x + mha(h, h, lp["self_attn"], heads, causal=True, impl=impl,
                   lora=la.get("self_attn") if la else None, dropout=dropout,
                   site=site + "/self", quant=quant)


def _dec_cross_half(x, enc_out, lp, la, heads: int, impl: str, dropout,
                    site: str, quant):
    h = layer_norm(x, lp["ln2"])
    return x + mha(h, enc_out, lp["cross_attn"], heads, impl=impl,
                   lora=la.get("cross_attn") if la else None, dropout=dropout,
                   site=site + "/cross", quant=quant)


def decode_train(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: WhisperConfig,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False, attn_impl: str = "auto",
                 return_hidden: bool = False,
                 adapters: Optional[Params] = None,
                 dropout: Optional[LoraDropout] = None,
                 quant: Optional[Q.QuantConfig] = None) -> torch.Tensor:
    """Teacher-forced decode: tokens (B, T) → logits (B, T, vocab) fp32.

    attn_impl selects the causal self-attention's path; the
    cross-attention is promoted from "xla" to "auto" (the kernel), as in
    the JAX function. return_hidden: the post-ln hidden states (B, T, d)
    instead of logits, for the fused chunked loss (ops/fused_ce.py).
    adapters["decoder"]: self/cross-attention q/v adapters."""
    dec = params["decoder"]
    T = tokens.shape[1]
    x = dec["embed"].to(compute_dtype)[tokens]
    x = x + dec["pos"][:T].to(compute_dtype)[None]
    cross_impl = "auto" if attn_impl == "xla" else attn_impl
    H, L = cfg.decoder_heads, cfg.decoder_layers
    las = _layer_adapters(adapters, "decoder", L)
    for l, lp in enumerate(_unbind_layers(dec["layers"], L)):
        site = f"dec/{l}"
        x = _maybe_remat(_dec_self_half, remat, x, lp, las[l], H, attn_impl,
                         dropout, site, quant)
        x = _maybe_remat(_dec_cross_half, remat, x, enc_out, lp, las[l], H,
                         cross_impl, dropout, site, quant)
        x = _maybe_remat(_mlp_half, remat, x, lp["ln3"], lp["mlp"], quant)
    x = layer_norm(x, dec["ln_post"])
    if return_hidden:
        return x
    # tied output projection; logits in fp32 for a stable softmax/loss
    return torch.matmul(x.float(),
                        tied_logits_weight(dec["embed"], compute_dtype).t())


def forward(params: Params, mel: torch.Tensor, tokens: torch.Tensor,
            cfg: WhisperConfig, compute_dtype: torch.dtype = torch.bfloat16,
            remat: bool = False, attn_impl: str = "auto",
            decoder_attn_impl: Optional[str] = None,
            return_hidden: bool = False,
            adapters: Optional[Params] = None,
            dropout: Optional[LoraDropout] = None,
            quant: Optional[Q.QuantConfig] = None,
            fused_qkv: bool = True) -> torch.Tensor:
    """Full teacher-forced forward: (mel, decoder_input_ids) → logits.
    attn_impl selects the encoder attention, decoder_attn_impl the
    decoder's (defaults to attn_impl); fused_qkv as in `encode`."""
    enc_out = encode(params, mel, cfg, compute_dtype, remat, attn_impl,
                     adapters, dropout, quant, fused_qkv)
    dec_impl = attn_impl if decoder_attn_impl is None else decoder_attn_impl
    return decode_train(params, tokens, enc_out, cfg, compute_dtype, remat,
                        dec_impl, return_hidden, adapters, dropout, quant)


# ---------------------------------------------------------------------------
# incremental decoding with a KV cache (evaluation/decode.py)
# ---------------------------------------------------------------------------

def init_cache(cfg: WhisperConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, dense: bool = False,
               device="cpu") -> Params:
    """Zeroed self-attention cache: (L, B, T, d) for decode_step_fused
    (dense=True), (L, B, T, H, hd) for decode_step."""
    L, H = cfg.decoder_layers, cfg.decoder_heads
    hd = cfg.d_model // H
    shape = (L, batch, max_len, H * hd) if dense else (L, batch, max_len, H, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def precompute_cross_kv(params: Params, enc_out: torch.Tensor,
                        cfg: WhisperConfig, adapters: Optional[Params] = None,
                        quant: Optional[Q.QuantConfig] = None) -> Params:
    """Cross-attention K/V once per utterance: (L, B, S, H, hd) each (the
    v projection with its cross-attention adapter, when given)."""
    ca = params["decoder"]["layers"]["cross_attn"]
    ad = adapters.get("decoder") if adapters else None
    H = cfg.decoder_heads
    ks, vs = [], []
    for l in range(cfg.decoder_layers):
        lv = _layer(ad["cross_attn"]["v"], l) if ad else None
        ks.append(_split_heads(dense(enc_out, _layer(ca["k"], l), quant=quant), H))
        vs.append(_split_heads(dense(enc_out, _layer(ca["v"], l), lv, quant=quant), H))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


INV_127 = float(np.float32(1.0) / np.float32(127.0))   # XLA's constant for x / 127


def quantize_cross_kv(cross_kv: Params) -> Params:
    """int8 cross K/V for decoding (--decode_kv_int8): every step re-reads
    the whole (L, B, S, H, hd) cross K/V, the decode's largest read; int8
    with per-(batch, head) scales halves it. {k_q8, v_q8} (L, B, S, H, hd)
    int8 and {k_scale, v_scale} (L, B, 1, H, 1) fp32. The scale is the
    absmax times f32(1/127): the form XLA compiles the JAX function's
    `/ 127.0` to in the jitted decode."""
    out = {}
    for name in ("k", "v"):
        x = cross_kv[name].float()
        absmax = x.abs().amax(dim=(2, 4), keepdim=True)
        scale = absmax.clamp_min(1e-8) * INV_127
        out[name + "_q8"] = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        out[name + "_scale"] = scale
    return out


def _maybe_dequant_kv(k: torch.Tensor, scale: Optional[torch.Tensor],
                      dtype: torch.dtype) -> torch.Tensor:
    if scale is None:
        return k.to(dtype)
    return k.to(dtype) * scale.to(dtype)


def _cross_kv_layer(cross_kv: Params, l: int, dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer l's cross K/V in dtype, dequantized when int8."""
    if "k_q8" in cross_kv:
        return tuple(_maybe_dequant_kv(cross_kv[n + "_q8"][l], cross_kv[n + "_scale"][l],
                                       dtype) for n in "kv")
    return tuple(_maybe_dequant_kv(cross_kv[n][l], None, dtype) for n in "kv")


def tied_logits_weight(embed: torch.Tensor,
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """The tied output projection (V, d) as fp32 values of the embedding
    rounded to the compute dtype: an fp32 product with it is the JAX einsum
    of compute-dtype operands with fp32 accumulation and output (rounding
    the logits to bf16 would change argmax ties)."""
    return embed.to(compute_dtype).float()


def _embed(dec: Params, token: torch.Tensor, pos: int,
           compute_dtype: torch.dtype) -> torch.Tensor:
    return (dec["embed"][token].to(compute_dtype)
            + dec["pos"][pos].to(compute_dtype))                   # (B, d)


def _logits(x: torch.Tensor, dec: Params, compute_dtype: torch.dtype,
            logits_w: Optional[torch.Tensor]) -> torch.Tensor:
    w = logits_w if logits_w is not None else tied_logits_weight(
        dec["embed"], compute_dtype)
    return torch.matmul(x.to(compute_dtype).to(w.dtype), w.t())


def decode_step(params: Params, token: torch.Tensor, pos: int,
                cache: Params, cross_kv: Params, cfg: WhisperConfig,
                compute_dtype: torch.dtype = torch.bfloat16,
                logits_w: Optional[torch.Tensor] = None,
                adapters: Optional[Params] = None,
                quant: Optional[Q.QuantConfig] = None,
                cross_group: int = 1
                ) -> Tuple[torch.Tensor, Params]:
    """One autoregressive step, plain PyTorch (the reference the fused step
    is held against). token (B,), pos the current position; returns
    (logits (B, vocab) fp32, cache), the cache (L, B, T, H, hd) written in
    place at pos. logits_w: tied_logits_weight(...), made once per decode;
    adapters: unmerged decoder adapters. cross_kv may be int8
    (quantize_cross_kv), dequantized per layer. cross_group K > 1 (beam
    search): cross_kv has B / K rows, shared by each K consecutive token
    rows, whose queries fold into the query axis of one attention."""
    dec = params["decoder"]
    x = _embed(dec, token, pos, compute_dtype)[:, None, :]        # (B, 1, d)
    H = cfg.decoder_heads
    ck, cv = cache["k"], cache["v"]
    valid = (torch.arange(ck.shape[2], device=x.device) <= pos)[None, None, None, :]
    ad = adapters.get("decoder") if adapters else None
    for l in range(cfg.decoder_layers):
        lp = _layer(dec["layers"], l)
        la = _layer(ad, l) if ad else {}
        sl, cl = la.get("self_attn", {}), la.get("cross_attn", {})
        sa, ca = lp["self_attn"], lp["cross_attn"]
        h = layer_norm(x, lp["ln1"])
        q = _split_heads(dense(h, sa["q"], sl.get("q"), quant=quant), H)
        ck[l, :, pos] = _split_heads(dense(h, sa["k"], quant=quant), H)[:, 0].to(ck.dtype)
        cv[l, :, pos] = _split_heads(dense(h, sa["v"], sl.get("v"), quant=quant),
                                     H)[:, 0].to(cv.dtype)
        a = xla_attention(q, ck[l].to(x.dtype), cv[l].to(x.dtype), valid)
        x = x + dense(_merge_heads(a), sa["o"], quant=quant)

        h = layer_norm(x, lp["ln2"])
        q2 = _split_heads(dense(h, ca["q"], cl.get("q"), quant=quant), H)
        xk, xv = _cross_kv_layer(cross_kv, l, x.dtype)
        a2 = xla_attention(q2.reshape((-1, cross_group) + q2.shape[2:]), xk, xv)
        x = x + dense(_merge_heads(a2.reshape(q2.shape)), ca["o"], quant=quant)

        h = layer_norm(x, lp["ln3"])
        x = x + mlp_block(h, lp["mlp"], quant)
    x = layer_norm(x, dec["ln_post"])
    return _logits(x[:, 0], dec, compute_dtype, logits_w), cache


def decode_step_fused(params: Params, token: torch.Tensor, pos: int,
                      cache: Params, cross_kv: Params, cfg: WhisperConfig,
                      s_valid: int,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      logits_w: Optional[torch.Tensor] = None,
                      ancestry: Optional[torch.Tensor] = None,
                      cross_group: int = 1
                      ) -> Tuple[torch.Tensor, Params]:
    """One autoregressive step through the fused layer kernels
    (ops/decoder_fused.py): per layer fused_qkv, self-attention fused_attn
    (fused_attn_beam with an ancestry map), cross-attention fused_attn and
    fused_mlp, each reading layer l of the stacked weights / cache / cross
    K/V in place.

    Requirements (arranged by evaluation/decode.py `_prepare_fused`): the
    adapters merged, the decoder's float weights cast to the compute dtype
    (an int8 projection {"w_q8", "w_scale"} passes its scale to the kernel,
    which applies it after the product), the cache from
    init_cache(dense=True), cross K/V dense (L, B, S_pad, d) with s_valid
    the real source length; int8 cross K/V as {k_q8, v_q8} (L, B, S_pad, d)
    with per-(batch, head) scales {k_scale_d, v_scale_d} (L, B, d).

    ancestry (beam search): (B, K, T) int32, the beam row whose cache slot
    t holds hypothesis (b, k)'s key at position t; the cache is never
    reordered. cross_group K: cross_kv holds B / K rows, each shared by K
    consecutive token rows (the cross K/V is never replicated per beam)."""
    if cfg.d_model // cfg.decoder_heads != DF.HEAD_DIM:
        raise ValueError(
            f"decode_step_fused requires {DF.HEAD_DIM}-dim heads; got "
            f"{cfg.d_model // cfg.decoder_heads}. Use decode_step for this model.")
    dec = params["decoder"]
    lay = dec["layers"]
    sa, ca, mlp = lay["self_attn"], lay["cross_attn"], lay["mlp"]

    def wpart(p):
        """(weight, int8 per-channel scale or None): a merged int8 base is
        mixed, each projection int8 or float on its own."""
        if Q.QUANT_KEY in p:
            return p[Q.QUANT_KEY], p[Q.SCALE_KEY]
        return p["w"], None

    (wq, sq), (wk, sk), (wv, sv), (wo, so) = (wpart(sa[n]) for n in "qkvo")
    (cq, csq), (co, cso) = wpart(ca["q"]), wpart(ca["o"])
    (w1, s1), (w2, s2) = wpart(mlp["fc1"]), wpart(mlp["fc2"])
    x = _embed(dec, token, pos, compute_dtype)
    ck, cv = cache["k"], cache["v"]
    if "k_q8" in cross_kv:
        xk, xv = cross_kv["k_q8"], cross_kv["v_q8"]
        xk_s, xv_s = cross_kv["k_scale_d"], cross_kv["v_scale_d"]
    else:
        xk, xv = cross_kv["k"], cross_kv["v"]
        xk_s = xv_s = None
    for l in range(cfg.decoder_layers):
        q, k_new, v_new = DF.fused_qkv(
            x, lay["ln1"]["scale"], lay["ln1"]["bias"],
            wq, sa["q"]["b"], wk, wv, sa["v"]["b"],
            wq_scale=sq, wk_scale=sk, wv_scale=sv, kv_dtype=ck.dtype, layer_idx=l)
        # in-place index assignment of the (l, :, pos, :) row: the JAX
        # step's dynamic_update_slice on the loop carry
        ck[l, :, pos] = k_new
        cv[l, :, pos] = v_new
        if ancestry is not None:
            x = DF.fused_attn_beam(x, ck, cv, wo, sa["o"]["b"], q=q, pos=pos,
                                   ancestry=ancestry, wo_scale=so, layer_idx=l)
        else:
            x = DF.fused_attn(x, ck, cv, wo, sa["o"]["b"], q=q, pos=pos,
                              wo_scale=so, layer_idx=l)
        x = DF.fused_attn(x, xk, xv, co, ca["o"]["b"],
                          s_valid=s_valid, ln_scale=lay["ln2"]["scale"],
                          ln_bias=lay["ln2"]["bias"], wq=cq,
                          bq=ca["q"]["b"], k_scale=xk_s, v_scale=xv_s,
                          wq_scale=csq, wo_scale=cso, layer_idx=l,
                          kv_group=cross_group)
        x = DF.fused_mlp(x, lay["ln3"]["scale"], lay["ln3"]["bias"],
                         w1, mlp["fc1"]["b"], w2, mlp["fc2"]["b"],
                         w1_scale=s1, w2_scale=s2, layer_idx=l)
    x = layer_norm(x, dec["ln_post"])
    return _logits(x, dec, compute_dtype, logits_w), cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

IGNORE_ID = -100  # label positions to ignore (the collator's pad mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross-entropy over labels != IGNORE_ID, with optional
    label smoothing (mean-logprob form). Returns (loss, num_tokens)."""
    mask = labels != IGNORE_ID
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.to(_acc(logits.dtype)), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    n = torch.clamp(mask.sum(), min=1)
    return nll.sum() / n, n

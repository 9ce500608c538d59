"""Seeded weights and adapters of Uni-MoE-2.0-Omni's speech-to-text path in
the port's tree layout (models/unimoe.py), made on the device.

The benchmark makes every input itself and hands the same trees to the
program and, regenerated from the seed after the window, to the reference
(reference_unimoe.py). The encoder is Whisper's, drawn from weights.py's
stream 0 by weights.py's law; the LM from stream 2; the adapters from
stream 1. Every LM product is drawn one layer (and expert) at a time in its
K-major layout (d_out, d_in) and quantized at once, per output channel, to
int8: the int8 base the traffic's --load_in_8bit runs, held once, so the
25 B parameters are never whole in a float type on the card.

The law (weights.py's, sized for this model's outlier classes): products
N(0, 1/d_in), biases N(0, 0.02^2), embeddings and the head N(0, 0.02^2)
(bf16, as the base holds them), the router N(0, 1/d) fp32. Norm scales are
1 + N(0, 0.1^2) except that every norm of a stack scales the same
OUTLIER_CHANNELS channels by U(6, 10): the systematic outlier features that
LLM.int8()'s calibrated columns (--int8_outlier_cols 8: at most 16 a class)
exist for. Sixteen a stack fill each class the norms feed with clear
outliers, so that no column near the threshold of 6 can enter a set by
rounding. The classes no norm feeds stay well under it: the expert gate is
drawn at unit variance over its input's (outliers included) and the up
projection at a quarter of it, so that silu(gate)·up, the down
projections' input, stays under 4.5; the encoder's final layer norm, the
projector's input, is at half scale. Adapters: a and b N(0, 0.02^2), e 1,
scaling alpha / rank.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from . import weights as WT

OUTLIER_CHANNELS = 16
GAIN2 = WT.FC1_GAIN2            # E[g^2] of an outlier gain g ~ U(6, 10)
ENCODER_STREAM, ADAPTER_STREAM, LM_STREAM = 0, 1, 2
UP_GAIN = 0.25

leaves = WT.leaves


def dims(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The widths of the configuration file (the published config's keys,
    the encoder's under "whisper_encoder", the pooling under "assumed")."""
    e = cfg["whisper_encoder"]
    d, H = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    pool = int(cfg["assumed"]["audio_pool"])
    return {"d": d, "L": int(cfg["num_hidden_layers"]), "H": H,
            "H_kv": int(cfg["num_key_value_heads"]), "hd": d // H,
            "Fs": int(cfg["shared_intermediate_size"]), "Ef": int(cfg["mlp_fixed_expert_num"]),
            "Fd": int(cfg["dynamic_intermediate_size"]),
            "Ed": int(cfg["mlp_dynamic_expert_num"]),
            "En": int(cfg["mlp_dynamic_null_expert_num"]), "V": int(cfg["vocab_size"]),
            "pool": pool, "A": int(e["max_source_positions"]) // pool,
            "d_e": int(e["d_model"]), "L_e": int(e["encoder_layers"]),
            "H_e": int(e["encoder_attention_heads"]), "ff": int(e["encoder_ffn_dim"]),
            "mels": int(e["num_mel_bins"]), "S": int(e["max_source_positions"])}


def quantize_kmajor(w: torch.Tensor):
    """(…, d_out, d_in) float → int8 of the same shape and the fp32
    scales (…, 1, d_out): symmetric, per output channel."""
    scale = torch.clamp(w.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale[..., None, :]


def _encoder(n: Dict[str, int], g: torch.Generator, device) -> Dict[str, Any]:
    """Whisper's encoder by weights.py's law, its stack's layer norms with
    OUTLIER_CHANNELS outlier channels, the final one at half scale."""
    d, ff, mels, L = n["d_e"], n["ff"], n["mels"], n["L_e"]

    def normal(std, *shape):
        return torch.randn(shape, generator=g, device=device).mul_(std)

    def proj(d_in, d_out, bias=True):
        p = {"w": normal(1.0 / math.sqrt(d_in), L, d_in, d_out)}
        if bias:
            p["b"] = normal(0.02, L, d_out)
        return p

    chans = torch.randperm(d, generator=g, device=device)[:OUTLIER_CHANNELS]
    gain = torch.rand((OUTLIER_CHANNELS,), generator=g, device=device).mul_(4).add_(6)

    def ln(shape, outliers=True):
        scale = normal(0.1, *shape).add_(1.0)
        if outliers:
            scale[..., chans] = gain
        return {"scale": scale, "bias": normal(0.02, *shape)}

    h2 = 1.0 + OUTLIER_CHANNELS * (GAIN2 - 1.0) / d
    fc1 = proj(d, ff)
    fc1["w"].mul_(0.65 / math.sqrt(h2))
    post = ln((d,), outliers=False)
    post["scale"].mul_(0.5)
    return {"conv1": {"w": normal(1.0 / math.sqrt(3 * mels), 3, mels, d), "b": normal(0.02, d)},
            "conv2": {"w": normal(1.0 / math.sqrt(3 * d), 3, d, d), "b": normal(0.02, d)},
            "layers": {"ln1": ln((L, d)),
                       "attn": {"q": proj(d, d), "k": proj(d, d, bias=False),
                                "v": proj(d, d), "o": proj(d, d)},
                       "ln2": ln((L, d)), "mlp": {"fc1": fc1, "fc2": proj(ff, d)}},
            "ln_post": post}


def make_weights(cfg: Dict[str, Any], seed: int, device,
                 law: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """The tree the port's models/unimoe.init_params(int8=True) makes: the
    encoder fp32 (the program quantizes it as Whisper's), the LM's and the
    projector's products int8 K-major, embeddings and head bf16."""
    if law:
        raise ValueError(f"unknown weight-law keys {sorted(law)}")
    n = dims(cfg)
    encoder = _encoder(n, WT.generator(seed, ENCODER_STREAM, device), device)
    g = WT.generator(seed, LM_STREAM, device)
    d, L = n["d"], n["L"]
    kv = n["H_kv"] * n["hd"]

    def normal(std, *shape):
        return torch.randn(shape, generator=g, device=device).mul_(std)

    chans = torch.randperm(d, generator=g, device=device)[:OUTLIER_CHANNELS]
    gain = torch.rand((OUTLIER_CHANNELS,), generator=g, device=device).mul_(4).add_(6)
    h2 = 1.0 + OUTLIER_CHANNELS * (GAIN2 - 1.0) / d

    def norm(shape, outliers=True):
        scale = normal(0.1, *shape).add_(1.0)
        if outliers:
            scale[..., chans] = gain
        return {"scale": scale}

    def kmajor(std, lead, d_out, d_in, layers=None):
        """Drawn and quantized one layer at a time; layers None: one."""
        pre = () if layers is None else (layers,)
        q = torch.empty(pre + lead + (d_out, d_in), dtype=torch.int8, device=device)
        s = torch.empty(pre + lead + (1, d_out), dtype=torch.float32, device=device)
        for l in range(1 if layers is None else layers):
            ql, sl = quantize_kmajor(normal(std, *lead, d_out, d_in))
            (q if layers is None else q[l]).copy_(ql)
            (s if layers is None else s[l]).copy_(sl)
        return {"w_q8_nk": q, "w_scale": s}

    def experts(E, F):
        return {"gate": kmajor(1.0 / math.sqrt(d * h2), (E,), F, d, L),
                "up": kmajor(UP_GAIN / math.sqrt(d * h2), (E,), F, d, L),
                "down": kmajor(1.0 / math.sqrt(F), (E,), d, F, L)}

    embed = normal(0.02, n["V"], d).to(torch.bfloat16)
    projector = dict(kmajor(1.0 / math.sqrt(n["d_e"]), (), d, n["d_e"]), b=normal(0.02, d))
    attn = {"q": dict(kmajor(1.0 / math.sqrt(d), (), d, d, L), b=normal(0.02, L, d)),
            "k": dict(kmajor(1.0 / math.sqrt(d), (), kv, d, L), b=normal(0.02, L, kv)),
            "v": dict(kmajor(1.0 / math.sqrt(d), (), kv, d, L), b=normal(0.02, L, kv)),
            "o": kmajor(1.0 / math.sqrt(n["H"] * n["hd"]), (), d, d, L)}
    layers = {"ln1": norm((L, d)), "ln2": norm((L, d)), "attn": attn,
              "router": {"w": normal(1.0 / math.sqrt(d), L, d, n["Ed"] + n["En"])},
              "fixed": experts(n["Ef"], n["Fs"]), "dynamic": experts(n["Ed"], n["Fd"])}
    lm = {"embed": embed, "layers": layers, "norm": norm((d,), outliers=False),
          "head": normal(0.02, n["V"], d).to(torch.bfloat16)}
    return {"encoder": encoder, "encoder_pos": WT.sinusoids(n["S"], n["d_e"]).to(device),
            "projector": projector, "lm": lm}


def make_adapters(cfg: Dict[str, Any], rank: int, alpha: float, seed: int,
                  device, encoder: bool = True) -> Dict[str, Any]:
    """The fp32 adapter tree the port's training/lora.py reads: the LM's q
    (d → d) and v (d → its KV width), and with `encoder` the encoder's q
    and v."""
    n = dims(cfg)
    g = WT.generator(seed, ADAPTER_STREAM, device)

    def stack(L, d_in, d_out):
        return {"a": torch.randn((L, d_in, rank), generator=g, device=device).mul_(0.02),
                "e": torch.ones((L, 1, rank), device=device),
                "b": torch.randn((L, rank, d_out), generator=g, device=device).mul_(0.02),
                "scaling": torch.full((L,), alpha / rank, device=device)}

    d, kv = n["d"], n["H_kv"] * n["hd"]
    out = {"lm": {"q": stack(n["L"], d, d), "v": stack(n["L"], d, kv)}}
    if encoder:
        out["encoder"] = {t: stack(n["L_e"], n["d_e"], n["d_e"]) for t in ("q", "v")}
    return out

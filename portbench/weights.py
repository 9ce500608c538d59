"""Seeded weights and adapters in the port's tree layout, made on the device.

The benchmark makes every input itself and hands the same to the program
and to the reference (reference.py), which regenerates them from the seed
after the window instead of keeping a copy. One torch.Generator on the
device draws each stacked leaf in one call, in a fixed order, so a seed
gives the same numbers on every run of one card.

The law: products N(0, 1/d_in) (fc1 scaled so that fc2's inputs stay
under the outlier threshold), biases N(0, 0.02^2), embeddings and the
decoder's position table N(0, 0.02^2) as Whisper's, the encoder's sinusoid
table by its formula. Layer-norm scales are 1 + N(0, 0.1^2), except that
every layer norm of a stack scales the same OUTLIER_CHANNELS channels by
U(6, 10): the systematic outlier features of trained transformers, which
LLM.int8()'s outlier columns (the port's calibrated sets at threshold 6)
exist for. Adapters: a and b N(0, 0.02^2), e 1, scaling alpha / rank, so the
low-rank delta is in the forward from the first step (a trial's b starts
at 0; mid-training it does not).

A traffic file may change the law under its "weights" key. A serving mix
draws the decoder's position table at std 2: under the plain law a greedy
decode of random weights falls into one repeated token on some seeds, with
the top two logits far apart at every position, where no rounding of the
program or of its control changes a token and the check could not tell
them apart; a position table the size of the sublayers' outputs keeps the
decode moving, so near-ties come at many positions on every seed.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

OUTLIER_CHANNELS = 8
FC1_GAIN2 = 65.33          # E[g^2] of an outlier gain g ~ U(6, 10)
WEIGHT_STREAM, ADAPTER_STREAM = 0, 1


def dims(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The widths of a configuration file (Hugging Face key names)."""
    d = int(cfg["d_model"])
    return {"d": d, "L_e": int(cfg["encoder_layers"]), "L_d": int(cfg["decoder_layers"]),
            "H_e": int(cfg["encoder_attention_heads"]), "H_d": int(cfg["decoder_attention_heads"]),
            "ff": int(cfg["encoder_ffn_dim"]), "mels": int(cfg["num_mel_bins"]),
            "V": int(cfg["vocab_size"]), "S": int(cfg["max_source_positions"]),
            "P": int(cfg["max_target_positions"])}


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + stream) % (2 ** 63))
    return g


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's encoder position table: sin | cos over log-spaced timescales."""
    inc = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


def make_weights(cfg: Dict[str, Any], seed: int, device,
                 law: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """The fp32 weight tree the port's models/whisper.py reads. law: the
    traffic file's changes to the law above; "decoder_pos_std" draws the
    decoder's position table at that scale (the same draws, scaled)."""
    law = dict(law or {})
    pos_std = float(law.pop("decoder_pos_std", 0.02))
    if law:
        raise ValueError(f"unknown weight-law keys {sorted(law)}")
    n = dims(cfg)
    d, ff, mels = n["d"], n["ff"], n["mels"]
    g = generator(seed, WEIGHT_STREAM, device)

    def normal(std, *shape):
        return torch.randn(shape, generator=g, device=device).mul_(std)

    def proj(L, d_in, d_out, bias=True):
        p = {"w": normal(1.0 / math.sqrt(d_in), L, d_in, d_out)}
        if bias:
            p["b"] = normal(0.02, L, d_out)
        return p

    def attn(L):
        return {"q": proj(L, d, d), "k": proj(L, d, d, bias=False),
                "v": proj(L, d, d), "o": proj(L, d, d)}

    def ln(shape, outliers=None):
        scale = normal(0.1, *shape).add_(1.0)
        if outliers is not None:
            idx, gain = outliers
            scale[..., idx] = gain
        return {"scale": scale, "bias": normal(0.02, *shape)}

    # disjoint channels for the two stacks, so every int8 class holds
    # 2 x OUTLIER_CHANNELS clear outliers, as many as its calibrated set keeps
    chans = torch.randperm(d, generator=g, device=device)[: 2 * OUTLIER_CHANNELS]

    def outlier_set(part):
        gain = torch.rand((OUTLIER_CHANNELS,), generator=g, device=device).mul_(4).add_(6)
        return chans[part * OUTLIER_CHANNELS:(part + 1) * OUTLIER_CHANNELS], gain

    # fc1 drawn so that its outputs (fc2's inputs) stay below the outlier
    # threshold: a layer norm's output has variance h2 with the outliers in
    h2 = 1.0 + OUTLIER_CHANNELS * (FC1_GAIN2 - 1.0) / d

    def fc1(L):
        p = proj(L, d, ff)
        p["w"].mul_(0.65 / math.sqrt(h2))
        return p

    L_e, L_d = n["L_e"], n["L_d"]
    enc_out = outlier_set(0)
    encoder = {
        "conv1": {"w": normal(1.0 / math.sqrt(3 * mels), 3, mels, d), "b": normal(0.02, d)},
        "conv2": {"w": normal(1.0 / math.sqrt(3 * d), 3, d, d), "b": normal(0.02, d)},
        "layers": {"ln1": ln((L_e, d), enc_out), "attn": attn(L_e),
                   "ln2": ln((L_e, d), enc_out),
                   "mlp": {"fc1": fc1(L_e), "fc2": proj(L_e, ff, d)}},
        "ln_post": ln((d,)),
    }
    dec_out = outlier_set(1)
    decoder = {
        "embed": normal(0.02, n["V"], d),
        "pos": normal(pos_std, n["P"], d),
        "layers": {"ln1": ln((L_d, d), dec_out), "self_attn": attn(L_d),
                   "ln2": ln((L_d, d), dec_out), "cross_attn": attn(L_d),
                   "ln3": ln((L_d, d), dec_out),
                   "mlp": {"fc1": fc1(L_d), "fc2": proj(L_d, ff, d)}},
        "ln_post": ln((d,)),
    }
    return {"encoder": encoder, "decoder": decoder,
            "encoder_pos": sinusoids(n["S"], d).to(device)}


def make_adapters(cfg: Dict[str, Any], rank: int, alpha: float, seed: int,
                  device, encoder: bool = True) -> Dict[str, Any]:
    """The fp32 adapter tree (q and v of the decoder's self and cross
    attention, and with `encoder` of the encoder's) the port's
    training/lora.py reads."""
    n = dims(cfg)
    d = n["d"]
    g = generator(seed, ADAPTER_STREAM, device)

    def stack(L):
        return {"a": torch.randn((L, d, rank), generator=g, device=device).mul_(0.02),
                "e": torch.ones((L, 1, rank), device=device),
                "b": torch.randn((L, rank, d), generator=g, device=device).mul_(0.02),
                "scaling": torch.full((L,), alpha / rank, device=device)}

    out = {"decoder": {blk: {t: stack(n["L_d"]) for t in ("q", "v")}
                       for blk in ("self_attn", "cross_attn")}}
    if encoder:
        out["encoder"] = {t: stack(n["L_e"]) for t in ("q", "v")}
    return out


def leaves(tree: Dict[str, Any], prefix: str = ""):
    """(path, leaf) of a nested dict, keys sorted, paths "/"-joined."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}/{k}" if prefix else k
        out.extend(leaves(v, key) if isinstance(v, dict) else [(key, v)])
    return out

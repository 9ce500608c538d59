"""A plain fp32 reference of Uni-MoE-2.0-Omni's speech-to-text path, for the
port's CPU tests (tests/test_torch_unimoe.py). It imports neither JAX nor
the port: it reads the port's parameter tree as plain tensors and writes
out again every equation the port's models/unimoe.py follows (its module
docstring), with plain torch operations in fp32.

- The encoder: Whisper's (conv stem, GELU, sinusoid positions, pre-LN
  layers of softmax attention and a GELU MLP, the final layer norm).
- Pooling over `pool` frames, the linear projector, the embedded text.
- Each LM layer: RMSNorm, q/k/v (biases) with the q/v adapters, 1-D RoPE
  (rotate half), causal attention with each KV head shared by its group of
  query heads, o; RMSNorm, the fp32 softmax gate over the routable
  experts, the top-p (at most top-k) selection of the sorted
  probabilities, the fixed experts at weight 1, each selected dynamic
  expert at its probability, a null expert adding nothing.
- The final RMSNorm, the head, the mean cross-entropy over the labels
  that are not -100.
- The int8 base: a K-major weight {"w_q8_nk", "w_scale"} multiplies as
  LLM.int8()'s W8A8 (`w8a8`): each row of x quantized to int8 by its amax
  times f32(1/127), round half to even, the integer product exact in
  float64, scaled by the row's and the column's scales; the outlier
  columns (a calibrated set per (d_in, d_out) class) through an fp32 side
  product with the dequantized weight rows.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

INV_127 = float(np.float32(1.0) / np.float32(127.0))
IGNORE = -100


def w8a8(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
         idx: Optional[Sequence[int]] = None) -> torch.Tensor:
    """x (m, K) fp32 times the int8 weight wq (K, N) with column scales ws
    (N,): the W8A8 law, the columns idx through the float side product."""
    wq, ws = wq.double(), ws.reshape(-1).float()
    keep = torch.ones(x.shape[-1])
    addend = 0.0
    if idx is not None and len(idx):
        idx = torch.as_tensor(list(idx), dtype=torch.long)
        keep[idx] = 0.0
        addend = x[:, idx] @ (wq[idx].float() * ws)
    xk = x * keep
    xs = torch.clamp(xk.abs().amax(dim=-1, keepdim=True), min=1e-8) * INV_127
    x8 = torch.clamp(torch.round(xk / xs), -127, 127)
    return (x8.double() @ wq).float() * xs * ws + addend


class Reference:
    """The forward and loss of a parameter tree of models/unimoe.py's
    layout. cfg: the widths (dict); sets: calibrated outlier columns by
    (d_in, d_out) class for the int8 products (None: none)."""

    def __init__(self, params: Dict, cfg: Dict, adapters: Optional[Dict] = None,
                 sets: Optional[Dict[Tuple[int, int], Sequence[int]]] = None):
        self.p, self.c, self.ad, self.sets = params, cfg, adapters or {}, sets or {}

    # -- pieces
    def proj(self, x: torch.Tensor, p: Dict, ad: Optional[Dict] = None) -> torch.Tensor:
        if "w_q8_nk" in p or "w_q8" in p:
            wq = p["w_q8"] if "w_q8" in p else p["w_q8_nk"].transpose(-1, -2)
            klass = tuple(wq.shape)
            x2 = x.reshape(-1, klass[0])
            y = w8a8(x2, wq, p["w_scale"], self.sets.get(klass)).reshape(
                *x.shape[:-1], klass[1])
        else:
            y = x @ p["w"].float()
        if ad is not None:
            y = y + ((x @ ad["a"]) * ad["e"]) @ ad["b"] * ad["scaling"]
        if "b" in p:
            y = y + p["b"].float()
        return y

    @staticmethod
    def rms(x, scale, eps):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale

    @staticmethod
    def ln(x, p):
        return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=1e-5)

    @staticmethod
    def at(tree, i):
        return {k: Reference.at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    # -- the encoder
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        enc, c = self.p["encoder"], self.c
        x = F.gelu(F.conv1d(mel.transpose(1, 2), enc["conv1"]["w"].permute(2, 1, 0),
                            enc["conv1"]["b"], padding=1))
        x = F.gelu(F.conv1d(x, enc["conv2"]["w"].permute(2, 1, 0), enc["conv2"]["b"],
                            stride=2, padding=1)).transpose(1, 2)
        x = x + self.p["encoder_pos"][: x.shape[1]]
        H = c["encoder_heads"]
        for l in range(c["encoder_layers"]):
            lp = self.at(enc["layers"], l)
            ad = self.at(self.ad["encoder"], l) if "encoder" in self.ad else {}
            h = self.ln(x, lp["ln1"])
            q = self.proj(h, lp["attn"]["q"], ad.get("q"))
            k = self.proj(h, lp["attn"]["k"])
            v = self.proj(h, lp["attn"]["v"], ad.get("v"))
            B, T, d = q.shape
            hd = d // H
            s = (q.view(B, T, H, hd).transpose(1, 2) @ k.view(B, T, H, hd).permute(0, 2, 3, 1)
                 ) / math.sqrt(hd)
            o = (torch.softmax(s, -1) @ v.view(B, T, H, hd).transpose(1, 2))
            x = x + self.proj(o.transpose(1, 2).reshape(B, T, d), lp["attn"]["o"])
            h = self.ln(x, lp["ln2"])
            x = x + self.proj(F.gelu(self.proj(h, lp["mlp"]["fc1"])), lp["mlp"]["fc2"])
        return self.ln(x, enc["ln_post"])

    # -- the LM
    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, H, hd)."""
        T, hd = x.shape[1], x.shape[-1]
        inv = 1.0 / self.c["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd)
        f = torch.arange(T, dtype=torch.float64)[:, None] * inv[None]
        emb = torch.cat([f, f], -1)
        cos, sin = emb.cos().float()[:, None], emb.sin().float()[:, None]
        x1, x2 = x.chunk(2, -1)
        return x * cos + torch.cat([-x2, x1], -1) * sin

    def route(self, u: torch.Tensor, w: torch.Tensor):
        """For each row: [(routable expert, its probability)] of the
        selection, the shortest prefix of the sorted probabilities that
        reaches top_p, at most top_k long."""
        p = torch.softmax(u @ w.float(), -1)
        out = []
        for row, vals in zip(p, p.detach().tolist()):
            order = sorted(range(len(vals)), key=lambda i: (-vals[i], i))
            taken, total = [], 0.0
            for i in order[: self.c["top_k"]]:
                if total >= self.c["top_p"]:
                    break
                taken.append((i, row[i]))
                total += vals[i]
            out.append(taken)
        return out

    def swiglu(self, x, ex, e):
        part = {n: {k: v[e] for k, v in ex[n].items()} for n in ("gate", "up", "down")}
        return self.proj(F.silu(self.proj(x, part["gate"])) * self.proj(x, part["up"]),
                         part["down"])

    def moe(self, u: torch.Tensor, lp: Dict) -> torch.Tensor:
        c = self.c
        u2 = u.reshape(-1, u.shape[-1])
        y = sum(self.swiglu(u2, lp["fixed"], f) for f in range(c["fixed"]))
        rows = []
        for n, taken in enumerate(self.route(u2, lp["router"]["w"])):
            r = torch.zeros(u2.shape[-1])
            for e, pe in taken:
                if e < c["dynamic"]:          # a null expert adds nothing
                    r = r + pe * self.swiglu(u2[n:n + 1], lp["dynamic"], e)[0]
            rows.append(r)
        return (y + torch.stack(rows)).reshape(u.shape)

    def lm_layer(self, x: torch.Tensor, l: int) -> torch.Tensor:
        c = self.c
        lp = self.at(self.p["lm"]["layers"], l)
        ad = self.at(self.ad["lm"], l) if "lm" in self.ad else {}
        B, T, d = x.shape
        hd, Hq, Hk = c["head_dim"], c["heads"], c["kv_heads"]
        h = self.rms(x, lp["ln1"]["scale"], c["eps"])
        q = self.rope(self.proj(h, lp["attn"]["q"], ad.get("q")).view(B, T, Hq, hd))
        k = self.rope(self.proj(h, lp["attn"]["k"]).view(B, T, Hk, hd))
        v = self.proj(h, lp["attn"]["v"], ad.get("v")).view(B, T, Hk, hd)
        k = k.repeat_interleave(Hq // Hk, dim=2)       # query head j reads KV head j // group
        v = v.repeat_interleave(Hq // Hk, dim=2)
        s = q.transpose(1, 2) @ k.permute(0, 2, 3, 1) / math.sqrt(hd)
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
        o = (torch.softmax(s, -1) @ v.transpose(1, 2)).transpose(1, 2).reshape(B, T, d)
        x = x + self.proj(o, lp["attn"]["o"])
        return x + self.moe(self.rms(x, lp["ln2"]["scale"], c["eps"]), lp)

    def hidden(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The final-normed hidden states of the text positions."""
        c, lm = self.c, self.p["lm"]
        enc = self.encode(mel)
        B, S, e = enc.shape
        audio = self.proj(enc.reshape(B, S // c["pool"], c["pool"], e).mean(2),
                          self.p["projector"])
        x = torch.cat([audio, lm["embed"].float()[tokens]], 1)
        for l in range(c["layers"]):
            x = self.lm_layer(x, l)
        return self.rms(x, lm["norm"]["scale"], c["eps"])[:, audio.shape[1]:]

    def loss(self, mel: torch.Tensor, tokens: torch.Tensor, labels: torch.Tensor):
        logits = self.hidden(mel, tokens) @ self.p["lm"]["head"].float().t()
        mask = labels != IGNORE
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, torch.where(mask, labels, 0)[..., None])[..., 0]
        return (nll * mask).sum() / mask.sum()

"""The plain reference of Uni-MoE-2.0-Omni's speech-to-text path: training
steps in fp32 PyTorch, with TF32 off.

It imports nothing of the program. It takes from reference.py the log-mel
frontend, the Whisper encoder, the W8A8 law, the int8 base's calibration,
the adapters' form, AdaLoRA's orthogonality penalty and the labels, and
writes out here again, from models/unimoe.py's description, the rest: the
mean-pooled audio (`audio_pool` frames a token) through the linear
projector, the embedded text after it, and each LM layer:

    h = x + o(Attn(q, k, v)),  q, k, v of RMSNorm(x) (biases; the q and v
        adapters), 1-D RoPE (theta, rotate half), causal attention with each
        KV head shared by its group of query heads
    out = h + Σ_fixed SwiGLU_f(u) + Σ_{i ∈ S} p_i SwiGLU_i(u),  u = RMSNorm(h),
        p = softmax(W_r u) in fp32 over the dynamic and the null experts,
        S the shortest prefix of the sorted p that reaches top_p (at most
        top_k), a null expert adding nothing

then the final RMSNorm and the untied head over the text positions, the
mean cross-entropy over the labels, and the clipped AdamW update of the
adapters. Every LM product is int8 K-major (weights_unimoe.py) and
multiplies as W8A8 with the calibrated outlier columns of its (d_in,
d_out) class; the router is fp32 whatever the control does.

Memory: each encoder and LM layer runs under torch.utils.checkpoint; an
LM product dequantizes its layer's weight when it runs and drops it after,
so the base is held in int8 once; the logits are made 256 rows at a time.

`lower=True` (the control): every product the configuration states in
bf16 takes its operands in fp8 and every int8 product its operands in
int4, reference.py's rule.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import reference as RF
from . import weights_unimoe as WU


def whisper_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The encoder as a Whisper configuration of reference.py's (no decoder)."""
    e = cfg["whisper_encoder"]
    return {"d_model": e["d_model"], "encoder_layers": e["encoder_layers"], "decoder_layers": 0,
            "encoder_attention_heads": e["encoder_attention_heads"],
            "decoder_attention_heads": e["encoder_attention_heads"],
            "encoder_ffn_dim": e["encoder_ffn_dim"], "num_mel_bins": e["num_mel_bins"],
            "vocab_size": 1, "max_source_positions": e["max_source_positions"],
            "max_target_positions": 1}


class Quant(RF.Quant):
    """reference.py's int8 base for the encoder, and the same W8A8 law,
    calibration and (d_in, d_out) classes for the LM's K-major int8
    weights."""

    def kmajor(self, x: torch.Tensor, p: Dict[str, torch.Tensor],
               prec: RF.Precision) -> torch.Tensor:
        wq = p["w_q8_nk"].transpose(-1, -2).float()
        klass = tuple(wq.shape)
        x2 = x.reshape(-1, klass[0])
        if self.record is not None:
            a = x2.detach().abs().amax(dim=0)
            cur = self.record.get(klass)
            self.record[klass] = a if cur is None else torch.maximum(cur, a)
        if self.sets is not None:
            idx = self.sets.get(klass)
        elif self.k > 0:
            idx = torch.topk(x2.detach().abs().amax(dim=0), min(self.k, klass[0])).indices
        else:
            idx = None
        y = RF._W8A8.apply(x2, wq, p["w_scale"].reshape(1, -1), idx, prec.lower)
        return y.reshape(*x.shape[:-1], klass[1])


def _at(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class Model:
    """The forward and loss of weights_unimoe's tree."""

    def __init__(self, cfg: Dict[str, Any], weights: Dict[str, Any], prec: RF.Precision,
                 quant: Quant, adapters: Dict[str, Any], dropout: float):
        self.c, self.n = cfg, WU.dims(cfg)
        self.w, self.prec, self.quant, self.ad = weights, prec, quant, adapters or {}
        self.enc = RF.Model(whisper_cfg(cfg), weights, prec, quant, adapters, dropout,
                            remat=True)

    def set_stream(self, seed, step):
        self.enc.seed, self.enc.step = seed, step

    # -- pieces
    def _proj(self, x, p, ad=None, site=""):
        y = self.quant.kmajor(x, p, self.prec)
        if ad is not None:
            t = self.prec.mm(self.enc._drop(x, site), ad["a"]) * ad["e"]
            y = y + self.prec.mm(t, ad["b"]) * ad["scaling"]
        if "b" in p:
            y = y + p["b"]
        return y

    def _rms(self, x, scale):
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True)
                               + float(self.c["rms_norm_eps"])) * scale

    def _rope(self, x):
        T, hd = x.shape[1], x.shape[-1]
        inv = 1.0 / float(self.c["rope_theta"]) ** (
            torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
        f = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None]
        emb = torch.cat([f, f], dim=-1)
        cos, sin = emb.cos().float()[:, None], emb.sin().float()[:, None]
        x1, x2 = x.chunk(2, dim=-1)
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    def _swiglu(self, x, ex, e):
        part = {k: _at(ex[k], e) for k in ("gate", "up", "down")}
        return self._proj(F.silu(self._proj(x, part["gate"])) * self._proj(x, part["up"]),
                          part["down"])

    def _moe(self, u, lp):
        n = self.n
        u2 = u.reshape(-1, u.shape[-1])
        y = sum(self._swiglu(u2, lp["fixed"], f) for f in range(n["Ef"]))
        probs = torch.softmax(u2 @ lp["router"]["w"], dim=-1)
        p_sorted, idx = probs.sort(dim=-1, descending=True, stable=True)
        k = int(self.c["mlp_dynamic_top_k"])
        p_k, e_k = p_sorted[:, :k], idx[:, :k]
        before = torch.cat([torch.zeros_like(p_k[:, :1]), p_k.cumsum(dim=-1)[:, :-1]], dim=-1)
        taken = before < float(self.c["mlp_dynamic_top_p"])
        for e in range(n["Ed"]):                 # the null experts, >= Ed, add nothing
            pick = taken & (e_k == e)
            rows = pick.any(dim=-1).nonzero()[:, 0]
            if rows.numel():
                weight = (p_k * pick).sum(dim=-1)[rows]
                y = y.index_add(0, rows, weight[:, None] * self._swiglu(u2[rows],
                                                                         lp["dynamic"], e))
        return y.reshape(u.shape)

    def _layer(self, x, l):
        n = self.n
        lp = _at(self.w["lm"]["layers"], l)
        ad = _at(self.ad["lm"], l) if "lm" in self.ad else {}
        B, T, d = x.shape
        hd, H, Hk = n["hd"], n["H"], n["H_kv"]
        h = self._rms(x, lp["ln1"]["scale"])
        q = self._proj(h, lp["attn"]["q"], ad.get("q"), f"lm/{l}/q")
        k = self._proj(h, lp["attn"]["k"])
        v = self._proj(h, lp["attn"]["v"], ad.get("v"), f"lm/{l}/v")
        q = self._rope(q.view(B, T, H, hd)).transpose(1, 2)
        k = self._rope(k.view(B, T, Hk, hd)).repeat_interleave(H // Hk, dim=2).transpose(1, 2)
        v = v.view(B, T, Hk, hd).repeat_interleave(H // Hk, dim=2).transpose(1, 2)
        s = self.prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1),
                          float("-inf"))
        o = self.prec.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, T, d)
        x = x + self._proj(o, lp["attn"]["o"])
        return x + self._moe(self._rms(x, lp["ln2"]["scale"]), lp)

    def hidden(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The final-normed hidden states of the text positions."""
        n, lm = self.n, self.w["lm"]
        enc = self.enc.encode(mel)
        B, S, e = enc.shape
        audio = self._proj(enc.reshape(B, S // n["pool"], n["pool"], e).mean(dim=2),
                           self.w["projector"])
        x = torch.cat([audio, lm["embed"][tokens].float()], dim=1)
        for l in range(n["L"]):
            x = checkpoint(self._layer, x, l, use_reentrant=False) \
                if torch.is_grad_enabled() else self._layer(x, l)
        return self._rms(x, lm["norm"]["scale"])[:, audio.shape[1]:]

    def loss(self, mel, dec_in, labels) -> torch.Tensor:
        """Mean cross-entropy over the labels that are not IGNORE, the
        logits made 256 rows at a time."""
        h = self.hidden(mel, dec_in)
        h2, lab = h.reshape(-1, h.shape[-1]), labels.reshape(-1)
        mask = lab != RF.IGNORE
        safe = torch.where(mask, lab, torch.zeros_like(lab))
        # the head in fp32 (or, in the control, fp8) once: every block's
        # product keeps a reference to this one copy for its backward
        head = self.w["lm"]["head"].float()
        if self.prec.lower:
            head = RF._Fp8.apply(head)
        total = h2.new_zeros(())
        for a in range(0, h2.shape[0], 256):
            rows = h2[a:a + 256]
            lg = (RF._Fp8.apply(rows) if self.prec.lower else rows) @ head.t()
            nll = torch.logsumexp(lg, -1) - lg.gather(-1, safe[a:a + 256, None])[:, 0]
            total = total + torch.where(mask[a:a + 256], nll, torch.zeros_like(nll)).sum()
        return total / mask.sum().clamp(min=1)


def train_steps(cfg: Dict[str, Any], opts: Dict[str, Any], seed: int, pool,
                step_rows: List[Sequence[int]], calib_pool, device,
                lower: bool = False, half_batch: bool = False) -> Dict[str, Any]:
    """The cell's first len(step_rows) training steps from the seed's
    weights, as reference.train_steps returns them (losses, the first
    gradient's norms, each step's raw gradient norms, each trained leaf's
    change, the calibrated outlier sets). PEFT over the int8 base only."""
    if opts["mode"] != "peft" or not opts.get("int8"):
        raise ValueError("the Uni-MoE reference follows PEFT over the int8 base only")
    RF.fp32_mode()
    weights = WU.make_weights(cfg, seed, device)
    adapters = WU.make_adapters(cfg, opts["lora_rank"], opts["lora_alpha"], seed, device,
                                encoder=opts["encoder_adapters"])
    quant = Quant(weights, opts["outlier_cols"])
    model = Model(cfg, weights, RF.Precision(lower), quant, adapters, opts["lora_dropout"])
    prefix, eot = opts["prefix"], opts["eot"]
    n_mels = WU.dims(cfg)["mels"]
    out: Dict[str, Any] = {}
    if opts.get("calibrate"):
        mel, dec, lab = RF.batch_tensors(calib_pool, range(4), prefix, eot, n_mels, device)
        quant.calibrate(lambda: model.loss(mel, dec, lab), opts["outlier_threshold"],
                        2 * opts["outlier_cols"])
        out["outlier_sets"] = quant.sets_as_tuples()
    named = WU.leaves(adapters)
    trained = [(k, p) for k, p in named if k.endswith("/a") or k.endswith("/b")
               or (k.endswith("/e") and opts.get("adalora"))]
    for _, p in named:
        p.requires_grad_(True)
    start = [p.detach().clone() for _, p in trained]
    mu = [torch.zeros_like(p) for _, p in trained]
    nu = [torch.zeros_like(p) for _, p in trained]
    b1, b2, eps, wd = 0.9, 0.98, 1e-8, opts["weight_decay"]
    losses, raw_norms = [], []
    for s, rows in enumerate(step_rows):
        rows = list(rows)[: len(rows) // 2] if half_batch else rows
        mel, dec, lab = RF.batch_tensors(pool, rows, prefix, eot, n_mels, device)
        model.set_stream(opts["seed"], s)
        loss = model.loss(mel, dec, lab)
        total = loss + RF.orth_penalty(adapters, opts["orth_reg_weight"]) \
            if opts.get("adalora") else loss
        for _, p in named:
            p.grad = None
        total.backward()
        losses.append(float(loss.detach()))
        grads = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                 for _, p in trained]
        raw_norms.append([float(g.norm()) for g in grads])
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        if float(gnorm) >= opts["max_grad_norm"]:
            grads = [g / gnorm * opts["max_grad_norm"] for g in grads]
        if s == 0:
            out["first_grad"] = [float(g.norm()) for g in grads]
        lr = opts["lr"] * (1 - min(s, opts["max_steps"]) / opts["max_steps"])
        with torch.no_grad():
            for (_, p), g, m, v in zip(trained, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m / (1 - b1 ** (s + 1))) / ((v / (1 - b2 ** (s + 1))).sqrt() + eps)
                if wd:
                    upd = upd + wd * p
                p.add_(upd, alpha=-lr)
        del loss, total, grads, mel
    out.update(names=[k for k, _ in trained], losses=losses, raw_grad=raw_norms,
               change=[float((p.detach() - p0).norm()) for (_, p), p0 in zip(trained, start)])
    return out

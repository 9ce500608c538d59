"""Chunked fused cross-entropy over the tied output projection (PyTorch port).

Counterpart of asr_finetune_tpu/ops/fused_ce.py `fused_cross_entropy` (:49),
which is XLA in the JAX package (no Pallas kernel), so this is plain PyTorch:
the projection onto the (V, d) embedding and the CE reduction are fused and
chunked over rows (256 rows per tile), so only a (chunk, V) fp32 logits tile
is live (V = 51866 at large-v3: ~53 MB a tile, against ~160 MB for the
(4, 192, V) logits of a training batch); the backward recomputes each tile
instead of storing it. Same semantics as models/whisper.py cross_entropy:
labels == -100 ignored, optional label smoothing (mean-logprob form).

Logits are fp32 products of compute-dtype operands: both are rounded to the
compute dtype and multiplied in fp32 (the JAX dot with
preferred_element_type=float32), never rounded back to bf16.
"""
from __future__ import annotations

from typing import Tuple

import torch

IGNORE_ID = -100
DEFAULT_CHUNK = 256  # rows per logits tile: 256 x 51866 fp32 ≈ 53 MB


def _tiles(n: int, chunk: int):
    return [(i, min(i + chunk, n)) for i in range(0, n, chunk)]


class FusedCrossEntropy(torch.autograd.Function):
    """(x (B, T, d), embed (V, d), labels (B, T)) → (mean token loss,
    num_tokens); the backward recomputes every logits tile."""

    @staticmethod
    def forward(ctx, x, embed, labels, label_smoothing: float, chunk: int,
                embed_grad: bool):
        B, T, d = x.shape
        V = embed.shape[0]
        e = embed.detach().to(x.dtype).float()                 # (V, d)
        x2 = x.detach().reshape(B * T, d)
        lab = labels.reshape(B * T)
        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        n_tok = torch.zeros((), dtype=torch.long, device=x.device)
        for a, b in _tiles(B * T, chunk):
            logits = torch.matmul(x2[a:b].float(), e.t())      # (c, V) fp32
            m = logits.amax(dim=-1)
            lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
            mask = lab[a:b] != IGNORE_ID
            safe = torch.where(mask, lab[a:b], torch.zeros_like(lab[a:b])).long()
            nll = lse - logits.gather(-1, safe[:, None])[:, 0]
            if label_smoothing > 0.0:
                smooth = lse - logits.sum(dim=-1) / V          # -mean_v logprob
                nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
            nll_sum = nll_sum + torch.where(mask, nll, torch.zeros_like(nll)).sum()
            n_tok = n_tok + mask.sum()
        n = torch.clamp(n_tok, min=1)
        ctx.save_for_backward(x, embed, labels, n)
        ctx.label_smoothing, ctx.chunk, ctx.embed_grad = (
            label_smoothing, chunk, embed_grad)
        ctx.mark_non_differentiable(n)
        return nll_sum / n, n

    @staticmethod
    def backward(ctx, g_loss, _g_n):
        x, embed, labels, n = ctx.saved_tensors
        ls = ctx.label_smoothing
        B, T, d = x.shape
        V = embed.shape[0]
        e = embed.to(x.dtype).float()
        x2 = x.reshape(B * T, d)
        lab = labels.reshape(B * T)
        scale = (g_loss / n.float()).float()
        dx = torch.empty((B * T, d), dtype=torch.float32, device=x.device)
        de = (torch.zeros((V, d), dtype=torch.float32, device=x.device)
              if ctx.embed_grad else None)
        for a, b in _tiles(B * T, ctx.chunk):
            xc = x2[a:b].float()
            p = torch.softmax(torch.matmul(xc, e.t()), dim=-1)  # (c, V) fp32
            mask = lab[a:b] != IGNORE_ID
            safe = torch.where(mask, lab[a:b], torch.zeros_like(lab[a:b])).long()
            target = torch.zeros_like(p).scatter_(1, safe[:, None], 1.0)
            if ls > 0.0:
                target = (1.0 - ls) * target + ls / V
            dlogits = torch.where(mask[:, None], (p - target) * scale,
                                  torch.zeros_like(p))
            dlc = dlogits.to(x.dtype).float()
            dx[a:b] = torch.matmul(dlc, e)
            if de is not None:
                de += torch.matmul(dlc.t(), xc)
        dx = dx.reshape(B, T, d).to(x.dtype)
        if de is not None:
            de = de.to(embed.dtype)
        elif ctx.needs_input_grad[1]:
            de = torch.zeros_like(embed)       # a frozen table: no dE product
        return dx, de, None, None, None, None


def fused_cross_entropy(x: torch.Tensor, embed: torch.Tensor,
                        labels: torch.Tensor, label_smoothing: float = 0.0,
                        chunk: int = DEFAULT_CHUNK, embed_grad: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) hidden states, embed (V, d) tied table, labels (B, T) →
    (mean token loss, num_tokens), as models/whisper.py cross_entropy of
    the tied logits. embed_grad=False (a frozen table) skips the dE
    product."""
    return FusedCrossEntropy.apply(x, embed, labels, float(label_smoothing),
                                   int(chunk), bool(embed_grad))

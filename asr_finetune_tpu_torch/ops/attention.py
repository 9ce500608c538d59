"""Attention dispatch (counterpart of asr_finetune_tpu/ops/attention.py).

Non-causal unmasked attention goes to the encoder-attention kernel
(ops/encoder_attention.py; its plain version on the CPU) unless the caller
asks for impl="xla"; masked or causal calls take plain softmax attention
with `xla_attention`'s semantics. `impl` is the JAX package's knob
(`TrainStepConfig.attn_impl` / `decoder_attn_impl`): "auto" (the kernel
where it applies) or "xla" (plain attention). The TPU-only pieces of the
JAX module are not ported: the upstream Pallas `flash` call and its
impl="flash", its block-size table (`_pick_block`) and the VMEM bound that
gated the dense kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from .encoder_attention import encoder_attention


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  causal: bool = False) -> torch.Tensor:
    """Plain attention over (B, T, H, hd): logits of (q*scale)·k accumulated
    in fp32, masked to the dtype's minimum, fp32 softmax, probs cast to q's
    dtype, then probs·v."""
    hd = q.shape[-1]
    acc = torch.promote_types(q.dtype, torch.float32)
    qs = (q * hd ** -0.5).to(acc)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs, k.to(acc))
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        cm = torch.tril(torch.ones((Tq, Tk), dtype=torch.bool,
                                   device=q.device))[None, None]
        mask = cm if mask is None else (mask & cm)
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.tensor(torch.finfo(acc).min, dtype=acc,
                                          device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(acc), v.to(acc))
    return out.to(q.dtype)


IMPLS = ("auto", "xla")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              causal: bool = False, impl: str = "auto") -> torch.Tensor:
    """(B, T, H, hd) attention: with impl "auto" the encoder-attention
    kernel for non-causal unmasked calls (the encoder's self-attention, the
    teacher-forced cross-attention), plain softmax otherwise; impl "xla"
    always plain softmax."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}: have {IMPLS}")
    if impl == "auto" and mask is None and not causal:
        return encoder_attention(q, k, v)
    return xla_attention(q, k, v, mask, causal)

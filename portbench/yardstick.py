"""The card's peaks, the useful work of a step, and the bound of each call.

A frozen copy of the port's utils/flops.py arithmetic (useful matmul FLOPs,
remat's recompute excluded) and of chip_smoke.py's roofline rule: a call's
bound is max(bytes / HBM bandwidth, operations / the peak of their type),
each input byte read once and each output byte written once, from the
call's logical shapes whatever kernel computes it.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
PEAK_BF16 = PEAK_OPS["bfloat16"]


def bound_s(nbytes: float, ops: float, kind: str = "bfloat16") -> float:
    """The least time the card could take for a call, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind])


# ------------------------------------------------------------ useful FLOPs

def encoder_flops(n: Dict[str, int], batch: int, frames: int = 3000) -> float:
    """Forward matmul FLOPs of the encoder (conv stem and layers)."""
    d, ff, L = n["d"], n["ff"], n["L_e"]
    T = frames // 2
    f = 2.0 * batch * frames * 3 * n["mels"] * d + 2.0 * batch * T * 3 * d * d
    per_layer = 4 * 2.0 * T * d * d + 2 * 2.0 * T * T * d + 2 * 2.0 * T * d * ff
    return f + batch * L * per_layer


def decoder_flops(n: Dict[str, int], batch: int, label_len: int,
                  frames: int = 3000) -> float:
    """Forward matmul FLOPs of the teacher-forced decoder and the logits."""
    d, ff, L, V = n["d"], n["ff"], n["L_d"], n["V"]
    T, S = label_len, frames // 2
    per_layer = (4 * 2.0 * T * d * d + 2 * 2.0 * T * T * d + 2 * 2.0 * T * d * d
                 + 2 * 2.0 * S * d * d + 2 * 2.0 * T * S * d + 2 * 2.0 * T * d * ff)
    return batch * L * per_layer + 2.0 * batch * T * d * V


def train_step_flops(n: Dict[str, int], batch: int, label_len: int, mode: str) -> float:
    """Useful FLOPs of a training step: 3x the forward in full fine-tuning;
    2x with adapters in the encoder (forward and the input gradients)."""
    f = encoder_flops(n, batch) + decoder_flops(n, batch, label_len)
    return (3.0 if mode == "full" else 2.0) * f


def decode_position_flops(n: Dict[str, int], rows: int, pos: int) -> float:
    """Useful FLOPs of one greedy decode position over `rows` rows: every
    decoder layer's q/k/v/o, cross q/o and MLP products, its self attention
    over pos + 1 keys and cross attention over the source, and the logits."""
    d, ff, L, S = n["d"], n["ff"], n["L_d"], n["S"]
    per_layer = 2.0 * (6 * d * d + 2 * d * ff) + 4.0 * (pos + 1) * d + 4.0 * S * d
    return rows * (L * per_layer + 2.0 * d * n["V"])


def cross_kv_flops(n: Dict[str, int], rows: int) -> float:
    """The cross-attention K/V projections, once per utterance."""
    return rows * n["L_d"] * 2 * 2.0 * n["S"] * n["d"] * n["d"]


# ------------------------------------------------------------ call bounds

def attention_fwd_bound(B: int, H: int, Tq: int, Tk: int, hd: int, elem: int = 2) -> float:
    """Encoder-attention forward: q, k, v read, out written, (B, H, Tq) fp32
    logsumexp written; 4 B H Tq Tk hd operations (QK^T and PV)."""
    nbytes = elem * B * H * hd * (2 * Tq + 2 * Tk) + 4 * B * H * Tq
    return bound_s(nbytes, 4.0 * B * H * Tq * Tk * hd)


def attention_bwd_bound(B: int, H: int, Tq: int, Tk: int, hd: int, elem: int = 2) -> float:
    """Its backward: q, k, v, do and the logsumexp read, dq, dk, dv written;
    the five products (S again, dV, dP, dQ, dK), 10 B H Tq Tk hd."""
    nbytes = elem * B * H * hd * (3 * Tq + 4 * Tk) + 4 * B * H * Tq
    return bound_s(nbytes, 10.0 * B * H * Tq * Tk * hd)


def w8a8_bound(m: int, K: int, N: int, elem: int = 2, addend: bool = False) -> float:
    """The W8A8 product with its row quantisation: x read in its dtype, the
    int8 weight and the fp32 scales read, y written; 2 m K N int8
    operations."""
    nbytes = elem * m * K + K * N + 4 * N + elem * m * N + (4 * m * N if addend else 0)
    return bound_s(nbytes, 2.0 * m * K * N, "int8")


def decode_layers_bound(n: Dict[str, int], rows: int, pos: int, elem: int = 2) -> float:
    """The fused decoder kernels of one greedy position over every layer:
    each layer's weights (q/k/v/o, cross q/o, fc1, fc2) and layer norms
    read, the self K/V cache read up to pos and its new row written, the
    cross K/V of the real source read, x read and written; the products and
    both attentions' operations."""
    d, ff, L, S = n["d"], n["ff"], n["L_d"], n["S"]
    weights = elem * (6 * d * d + 2 * d * ff) + elem * (7 * d + ff) + 4 * 6 * d
    cache = elem * rows * 2 * d * (pos + 1)
    cross = elem * rows * 2 * S * d
    act = elem * rows * d * 8
    ops = rows * (2.0 * (6 * d * d + 2 * d * ff) + 4.0 * (pos + 1) * d + 4.0 * S * d)
    return L * bound_s(weights + cache + cross + act, ops)


# ------------------------------------------------------------ kernel names

ATTN_FWD, ATTN_BWD, W8A8 = "attention forward", "attention backward", "W8A8"
DECODER = "decoder kernels"


def kernel_category(name: str) -> str:
    """chip_smoke.py's grouping of the profiler's kernel names, for the
    kernels whose rooflines the benchmark reads ("other" for the rest)."""
    low = name.lower()
    if "enc_attn_bwd" in low:
        return ATTN_BWD
    if "enc_attn_fwd" in low:
        return ATTN_FWD
    if "w8a8" in low or "quantize_rows" in low:
        return W8A8
    if any(s in low for s in ("gemv_kernel", "attn_partial", "attn_combine", "mlp_fc",
                              "attn_q_kernel", "attn_chunk", "attn_wo", "qkv_kernel")):
        return DECODER
    return "other"

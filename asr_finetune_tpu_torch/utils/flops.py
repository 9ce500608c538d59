"""Analytic model FLOPs of a Whisper training step, and MFU.

A copy of asr_finetune_tpu/utils/flops.py for the port: the useful matmul
FLOPs of a step (remat's recompute is excluded: it is overhead, not work),
so a measured step time gives an MFU against the card's peak. The peak is
the H100 SXM's dense bf16 rate from NVIDIA's data sheet, the rate the
port's roofline bounds are reckoned against (PERF.md §3).
"""
from __future__ import annotations

# dense bf16 peak per card, TFLOP/s (data sheet, at the 700 W power limit)
PEAK_TFLOPS = {
    "h100": 989.0,   # H100 SXM
}


def encoder_flops(cfg, batch: int, frames: int = 3000) -> float:
    """Forward matmul FLOPs of the encoder (conv stem + layers)."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.encoder_layers
    T = frames // 2  # after stride-2 conv2
    f = 0.0
    f += 2.0 * batch * frames * 3 * cfg.num_mel_bins * d        # conv1
    f += 2.0 * batch * T * 3 * d * d                            # conv2
    per_layer = (4 * 2.0 * T * d * d                            # qkvo
                 + 2 * 2.0 * T * T * d                          # attn (qk + pv)
                 + 2 * 2.0 * T * d * ff)                        # mlp
    f += batch * L * per_layer
    return f


def decoder_flops(cfg, batch: int, label_len: int, frames: int = 3000) -> float:
    """Forward matmul FLOPs of the decoder (teacher-forced) + logits."""
    d, ff, L, V = cfg.d_model, cfg.d_ff, cfg.decoder_layers, cfg.vocab_size
    T, S = label_len, frames // 2
    per_layer = (4 * 2.0 * T * d * d                            # self qkvo
                 + 2 * 2.0 * T * T * d                          # self attn
                 + 2 * 2.0 * T * d * d                          # cross q,o
                 + 2 * 2.0 * S * d * d                          # cross k,v
                 + 2 * 2.0 * T * S * d                          # cross attn
                 + 2 * 2.0 * T * d * ff)                        # mlp
    f = batch * L * per_layer
    f += 2.0 * batch * T * d * V                                # tied logits
    return f


def train_step_flops(cfg, batch: int, label_len: int, mode: str = "peft",
                     frames: int = 3000, encoder_adapted: bool = True) -> float:
    """Useful FLOPs of one training step.

    full: fwd + bwd ≈ 3x fwd everywhere.
    peft with encoder adapters (the default, reference PEFT parity —
    target_modules=['q_proj','v_proj'] matches the encoder too,
    trainers.py:525): every layer pays fwd + dx ≈ 2x; adapter dw is
    negligible (rank ≪ d).
    peft decoder-only (encoder_adapted=False): the encoder has no trainable
    dependency, so its backward never runs → encoder fwd only.
    """
    enc = encoder_flops(cfg, batch, frames)
    dec = decoder_flops(cfg, batch, label_len, frames)
    if mode == "full":
        return 3.0 * (enc + dec)
    if encoder_adapted:
        return 2.0 * (enc + dec)
    return enc + 2.0 * dec


def mfu(flops_per_step: float, step_seconds: float,
        chip: str = "h100", n_chips: int = 1) -> float:
    """Useful FLOPs per second over the cards' dense bf16 peak."""
    peak = PEAK_TFLOPS[chip] * 1e12 * n_chips
    return flops_per_step / step_seconds / peak

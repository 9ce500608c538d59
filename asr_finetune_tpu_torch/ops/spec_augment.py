"""SpecAugment (frequency and time masking) of log-mel features on the device.

Counterpart of asr_finetune_tpu/ops/spec_augment.py (Park et al. 2019, the
LibriSpeech LD policy): per utterance `n_freq_masks` masks of width
U(0, freq_mask_param) over the mel bins and `n_time_masks` of width
U(0, time_mask_param) over the frames, filled with the utterance's mean.

The JAX `spec_augment` is split in two so that a test can feed the JAX
masks to the port:
- `draw_masks` draws the (B, F) and (B, T) masks from an explicit
  torch.Generator on the features' device, by the JAX `_axis_mask` law:
  widths randint(0, max_width + 1), starts randint(0, max(L - w, 1)) with
  the top exclusive, max_width = min(param, L);
- `apply_masks` fills the masked positions with the per-utterance mean
  over (T, F) of the unmasked features in fp32 (what the JAX code computes,
  :52; its docstring says "batch-feature mean"), or with `mask_value`.

Everything runs on the device: no `.item()`, no host copy, no sync. The
train step draws each micro-batch's masks from its own stream
(training/train_step.py); under data parallelism a rank draws the global
batch's masks and keeps its own rows (`rows`, `row0`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    freq_mask_param: int = 27      # LibriSpeech LD policy
    n_freq_masks: int = 2
    time_mask_param: int = 100
    n_time_masks: int = 2
    mask_value: Optional[float] = None  # None: the per-utterance mean


def draw_spans(generator: torch.Generator, batch: int, length: int, max_width: int,
               n_masks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(widths, starts), each (batch, n_masks) int64 on the generator's
    device: widths U{0..max_width}, starts U{0..max(length - w, 1) - 1}."""
    dev = generator.device
    widths = torch.randint(0, max_width + 1, (batch, n_masks), generator=generator,
                           device=dev)
    high = torch.clamp(length - widths, min=1)
    # a uniform draw below a per-element bound: floor(u * high) with u in [0, 1)
    # in float64, where u * high < high holds for every high below 2^52
    u = torch.rand((batch, n_masks), generator=generator, device=dev,
                   dtype=torch.float64)
    starts = torch.floor(u * high).long()
    return widths, starts


def spans_to_mask(widths: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """(B, length) bool, True where any of a row's spans covers the position."""
    pos = torch.arange(length, device=widths.device)[None, None, :]
    m = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return m.any(dim=1)


def draw_masks(generator: torch.Generator, batch: int, frames: int, mels: int,
               cfg: SpecAugmentConfig = SpecAugmentConfig()
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fmask (B, F), tmask (B, T)) bool masks, True where masked."""
    fw, fs = draw_spans(generator, batch, mels, min(cfg.freq_mask_param, mels),
                        cfg.n_freq_masks)
    tw, ts = draw_spans(generator, batch, frames, min(cfg.time_mask_param, frames),
                        cfg.n_time_masks)
    return spans_to_mask(fw, fs, mels), spans_to_mask(tw, ts, frames)


def apply_masks(mel: torch.Tensor, fmask: torch.Tensor, tmask: torch.Tensor,
                mask_value: Optional[float] = None) -> torch.Tensor:
    """mel (B, T, F) with every masked position (its bin or its frame
    masked) replaced by the utterance's fp32 mean over (T, F), or by
    mask_value."""
    masked = fmask[:, None, :] | tmask[:, :, None]                  # (B, T, F)
    if mask_value is None:
        fill = mel.float().mean(dim=(1, 2), keepdim=True).to(mel.dtype)
    else:
        fill = torch.tensor(mask_value, dtype=mel.dtype, device=mel.device)
    return torch.where(masked, fill, mel)


def spec_augment(generator: torch.Generator, mel: torch.Tensor,
                 cfg: SpecAugmentConfig = SpecAugmentConfig(), rows: int = 0,
                 row0: int = 0) -> torch.Tensor:
    """mel (B, T, F) → masked mel. With rows > 0, mel holds rows [row0,
    row0 + B) of a batch of `rows`: the masks are drawn for all rows and
    this part's are kept, so they are the ones one process would draw."""
    B, T, F = mel.shape
    fmask, tmask = draw_masks(generator, rows or B, T, F, cfg)
    if rows:
        fmask, tmask = fmask[row0: row0 + B], tmask[row0: row0 + B]
    return apply_masks(mel, fmask, tmask, cfg.mask_value)

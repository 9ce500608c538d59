"""The training step, full fine-tuning (PyTorch port).

Counterpart of asr_finetune_tpu/training/train_step.py (`make_train_step`
:129, `make_loss_fn` :83, `make_eval_loss_step` :245) in mode "full":

- the loss: log-mel on the device from raw audio (when the batch carries
  "audio"), the teacher-forced forward in the compute dtype with fp32
  master weights cast at use, then the fused chunked cross-entropy
  (ops/fused_ce.py) or `cross_entropy` of the full logits;
- gradients land on the fp32 masters (`.grad`), summed over `accum_steps`
  microbatches (every batch leaf then has a leading (accum, micro) shape)
  and averaged;
- metrics: `loss` (mean over microbatches), `tokens` (their sum) and
  `grad_norm`, the global norm before clipping (`optax.global_norm(grads)`);
- AdamW (training/optim.py) updates the masters in place; the state's step
  counter drives the schedule.

Metrics stay on the device: the trainer fetches a whole logging window at
once. Not ported (their flags raise NotImplementedError in run.py): PEFT
(LoRA/AdaLoRA adapters, the int8 base), SpecAugment, host offload and
tensor parallelism.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models import whisper as W
from ..models.configs import WhisperConfig
from ..ops import logmel as logmel_ops
from ..ops.fused_ce import fused_cross_entropy
from .optim import AdamW

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainStepConfig:
    accum_steps: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    label_smoothing: float = 0.0
    on_device_logmel: bool = False      # batch carries "audio" not "mel"
    n_mels: int = 80
    attn_impl: str = "auto"             # encoder: the attention kernel
    decoder_attn_impl: str = "xla"      # causal self-attention stays plain;
                                        # cross-attention is promoted to auto
    fused_ce: bool = True               # chunked CE; (B, T, V) logits never exist


def leaves(tree: Params, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf in a fixed order (sorted keys)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}/{k}" if prefix else k
        out.extend(leaves(v, key) if isinstance(v, dict) else [(key, v)])
    return out


def make_train_state(params: Params, opt: AdamW) -> Dict[str, Any]:
    """{"step", "params", "opt_state"}: the fp32 masters become leaves that
    require grad, in place in the tree."""
    for _, p in leaves(params):
        if p.dtype != torch.float32:
            raise TypeError(f"full fine-tuning keeps fp32 master weights, got "
                            f"a {p.dtype} leaf")
        p.requires_grad_(True)
    return {"step": 0, "params": params,
            "opt_state": opt.init([p for _, p in leaves(params)])}


def _get_mel(batch: Dict[str, torch.Tensor], cfg: TrainStepConfig) -> torch.Tensor:
    if cfg.on_device_logmel:
        with torch.no_grad():
            return logmel_ops.log_mel_spectrogram(batch["audio"], n_mels=cfg.n_mels)
    return batch["mel"]


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            model_cfg: WhisperConfig, cfg: TrainStepConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean token loss, num_tokens) of one (micro)batch."""
    mel = _get_mel(batch, cfg)
    out = W.forward(params, mel, batch["decoder_input_ids"].long(), model_cfg,
                    compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                    attn_impl=cfg.attn_impl,
                    decoder_attn_impl=cfg.decoder_attn_impl,
                    return_hidden=cfg.fused_ce)
    if cfg.fused_ce:
        return fused_cross_entropy(out, params["decoder"]["embed"],
                                   batch["labels"], cfg.label_smoothing,
                                   embed_grad=True)
    return W.cross_entropy(out, batch["labels"], cfg.label_smoothing)


def compute_grads(params: Params, batch: Dict[str, torch.Tensor],
                  model_cfg: WhisperConfig, cfg: TrainStepConfig
                  ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Gradients of the loss on every leaf (averaged over microbatches) and
    the step's loss / token metrics; the gradients are the leaves' .grad."""
    ps = [p for _, p in leaves(params)]
    for p in ps:
        p.grad = None
    n_micro = cfg.accum_steps
    micro = ([batch] if n_micro == 1 else
             [{k: v[i] for k, v in batch.items()} for i in range(n_micro)])
    loss_sum = torch.zeros((), dtype=torch.float32)
    tok_sum = torch.zeros((), dtype=torch.long)
    for mb in micro:
        loss, n = loss_fn(params, mb, model_cfg, cfg)
        loss.backward()
        loss_sum = loss_sum.to(loss.device) + loss.detach()
        tok_sum = tok_sum.to(n.device) + n
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
    if n_micro > 1:
        torch._foreach_mul_(grads, 1.0 / n_micro)
    return grads, {"loss": loss_sum / n_micro, "tokens": tok_sum}


def make_train_step(model_cfg: WhisperConfig, opt: AdamW, cfg: TrainStepConfig):
    """Returns step(state, batch) → metrics; the state is updated in place."""
    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        params = state["params"]
        grads, metrics = compute_grads(params, batch, model_cfg, cfg)
        metrics["grad_norm"] = opt.step([p for _, p in leaves(params)], grads,
                                        state["opt_state"])
        for _, p in leaves(params):
            p.grad = None
        state["step"] += 1
        return metrics
    return step


def make_eval_loss_step(model_cfg: WhisperConfig, cfg: TrainStepConfig):
    """batch → {"loss", "tokens"} without gradients."""
    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, n = loss_fn(state["params"], batch, model_cfg, cfg)
        return {"loss": loss, "tokens": n}
    return step

"""The training step, full fine-tuning and PEFT (PyTorch port).

Counterpart of asr_finetune_tpu/training/train_step.py (`make_train_state`
:61, `make_loss_fn` :83, `make_train_step` :129, `make_eval_loss_step`
:245):

- the loss: log-mel on the device from raw audio (when the batch carries
  "audio"), the teacher-forced forward in the compute dtype, then the fused
  chunked cross-entropy (ops/fused_ce.py) or `cross_entropy` of the full
  logits;
- mode "full": fp32 master weights cast at use; gradients land on the
  masters (`.grad`);
- mode "peft": the adapters (training/lora.py) are what is differentiated;
  the frozen base (int8 or bf16) is passed in with no gradient. AdaLoRA's
  rank mask multiplies e in the forward only, lora dropout (on the adapter
  input, from a generator seeded by the config's seed and the step) is on
  in training, the orthogonality regulariser is added to the loss and
  reported as `orth_reg`, the fused CE computes no embedding gradient, and
  after the AdamW update `adalora_update_mask` reads the new adapters and
  this step's gradients;
- gradients are summed over `accum_steps` microbatches (every batch leaf
  then has a leading (accum, micro) shape) and averaged;
- metrics: `loss` (the cross-entropy, mean over microbatches), `tokens`
  (their sum), `grad_norm` (`optax.global_norm` of every differentiated
  leaf before clipping: in PEFT all adapter leaves, `scaling` and a frozen
  `e` included, while the clip sees only the trained leaves) and, under
  AdaLoRA, `orth_reg`;
- AdamW (training/optim.py) updates the trained leaves in place; the
  state's step counter drives the schedule.

Metrics stay on the device: the trainer fetches a whole logging window at
once. Not ported (their flags raise NotImplementedError in run.py):
SpecAugment, host offload and tensor parallelism.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models import whisper as W
from ..models.configs import WhisperConfig
from ..ops import logmel as logmel_ops
from ..ops.fused_ce import fused_cross_entropy
from ..ops.quant import QuantConfig
from . import lora as lora_lib
from .optim import AdamW, global_norm, leaves

Params = Dict[str, Any]

@dataclasses.dataclass
class TrainStepConfig:
    mode: str = "full"                  # "full" | "peft"
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
    max_steps: int = 10000              # AdaLoRA's budget schedule
    lora: Optional[lora_lib.LoraConfig] = None
    seed: int = 0                       # base of the lora dropout stream
    quant: Optional[QuantConfig] = None  # how int8 base weights are multiplied
    fused_qkv: bool = True              # the encoder may take the fused-qkv path
                                        # where ASR_TPU_FUSED_QKV engages it


def make_train_state(params: Params, opt: AdamW, adapters: Optional[Params] = None,
                     adalora: bool = False) -> Dict[str, Any]:
    """Full fine-tuning: {"step", "params", "opt_state"}, the fp32 masters
    made leaves that require grad, in place in the tree. PEFT (adapters
    given): also "adapters" (fp32, every leaf requiring grad; the base is
    left as it is) and under AdaLoRA "sensitivity" and "rank_mask". The
    optimizer state holds moments for the leaves `opt.trainable` picks, and
    their paths under "names"."""
    tree = params if adapters is None else adapters
    what = "full fine-tuning keeps fp32 master weights" if adapters is None \
        else "PEFT trains fp32 adapters"
    for _, p in leaves(tree):
        if p.dtype != torch.float32:
            raise TypeError(f"{what}, got a {p.dtype} leaf")
        p.requires_grad_(True)
    trained = opt.trainable(tree)
    opt_state = opt.init([p for _, p in trained])
    opt_state["names"] = [k for k, _ in trained]
    state = {"step": 0, "params": params, "opt_state": opt_state}
    if adapters is not None:
        state["adapters"] = adapters
        if adalora:
            state["sensitivity"] = lora_lib.init_sensitivity(adapters)
            state["rank_mask"] = lora_lib.init_rank_mask(adapters)
    return state


def _get_mel(batch: Dict[str, torch.Tensor], cfg: TrainStepConfig) -> torch.Tensor:
    if cfg.on_device_logmel:
        with torch.no_grad():
            return logmel_ops.log_mel_spectrogram(batch["audio"], n_mels=cfg.n_mels)
    return batch["mel"]


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            model_cfg: WhisperConfig, cfg: TrainStepConfig,
            adapters: Optional[Params] = None, rank_mask: Optional[Params] = None,
            dropout: Optional[W.LoraDropout] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(mean token loss, num_tokens, orth_reg or None) of one (micro)batch.
    PEFT: `adapters` with `rank_mask` applied to e in the forward."""
    peft = cfg.mode == "peft"
    if peft:
        adapters = lora_lib.apply_rank_mask(adapters, rank_mask)
    mel = _get_mel(batch, cfg)
    out = W.forward(params, mel, batch["decoder_input_ids"].long(), model_cfg,
                    compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                    attn_impl=cfg.attn_impl,
                    decoder_attn_impl=cfg.decoder_attn_impl,
                    return_hidden=cfg.fused_ce,
                    adapters=adapters if peft else None, dropout=dropout,
                    quant=cfg.quant, fused_qkv=cfg.fused_qkv)
    if cfg.fused_ce:
        loss, n = fused_cross_entropy(out, params["decoder"]["embed"],
                                      batch["labels"], cfg.label_smoothing,
                                      embed_grad=not peft)
    else:
        loss, n = W.cross_entropy(out, batch["labels"], cfg.label_smoothing)
    reg = None
    lcfg = cfg.lora
    if peft and lcfg is not None and lcfg.adalora and lcfg.orth_reg_weight > 0:
        reg = lora_lib.orth_regularizer(adapters, lcfg.orth_reg_weight)
    return loss, n, reg


def compute_grads(params: Params, batch: Dict[str, torch.Tensor],
                  model_cfg: WhisperConfig, cfg: TrainStepConfig,
                  adapters: Optional[Params] = None,
                  rank_mask: Optional[Params] = None, step: Optional[int] = None
                  ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Gradients of the loss (plus orth_reg) on every leaf of the params
    (full) or of the adapters (PEFT), in `leaves` order and averaged over
    microbatches, and the step's metrics. With `step` and a lora dropout
    rate, PEFT draws dropout masks (one stream per microbatch)."""
    peft = cfg.mode == "peft"
    ps = [p for _, p in leaves(adapters if peft else params)]
    for p in ps:
        p.grad = None
    n_micro = cfg.accum_steps
    micro = ([batch] if n_micro == 1 else
             [{k: v[i] for k, v in batch.items()} for i in range(n_micro)])
    loss_sum = torch.zeros((), dtype=torch.float32)
    tok_sum = torch.zeros((), dtype=torch.long)
    reg_sum = None
    for i, mb in enumerate(micro):
        dropout = None
        if peft and step is not None and cfg.lora is not None and cfg.lora.dropout > 0:
            dropout = W.LoraDropout(cfg.lora.dropout, cfg.seed, step * n_micro + i)
        loss, n, reg = loss_fn(params, mb, model_cfg, cfg, adapters, rank_mask, dropout)
        (loss if reg is None else loss + reg).backward()
        loss_sum = loss_sum.to(loss.device) + loss.detach()
        tok_sum = tok_sum.to(n.device) + n
        if reg is not None:
            reg_sum = reg.detach() if reg_sum is None else reg_sum + reg.detach()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
    if n_micro > 1:
        torch._foreach_mul_(grads, 1.0 / n_micro)
    metrics = {"loss": loss_sum / n_micro, "tokens": tok_sum}
    if reg_sum is not None:
        metrics["orth_reg"] = reg_sum / n_micro
    return grads, metrics


def _tree_like(tree: Params, values: Dict[str, torch.Tensor], prefix: str = "") -> Params:
    """A tree of tree's structure holding values[path] at each leaf."""
    return {k: (_tree_like(v, values, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict) else values[f"{prefix}/{k}" if prefix else k])
            for k, v in tree.items()}


def make_train_step(model_cfg: WhisperConfig, opt: AdamW, cfg: TrainStepConfig):
    """Returns step(state, batch) → metrics; the state is updated in place."""
    def full_step(state, batch):
        params = state["params"]
        grads, metrics = compute_grads(params, batch, model_cfg, cfg)
        metrics["grad_norm"] = opt.step([p for _, p in leaves(params)], grads,
                                        state["opt_state"])
        for _, p in leaves(params):
            p.grad = None
        return metrics

    def peft_step(state, batch):
        adapters, step_no = state["adapters"], state["step"]
        grads, metrics = compute_grads(state["params"], batch, model_cfg, cfg,
                                       adapters, state.get("rank_mask"), step_no)
        named = dict(zip((k for k, _ in leaves(adapters)), grads))
        metrics["grad_norm"] = global_norm(grads)
        adalora = cfg.lora is not None and cfg.lora.adalora and "sensitivity" in state
        trained = opt.trainable(adapters)
        # the update clips its gradients in place; the mask update reads the
        # unclipped ones (the adapters are small)
        tg = [named[k].clone() if adalora else named[k] for k, _ in trained]
        opt.step([p for _, p in trained], tg, state["opt_state"])
        if adalora:
            state["rank_mask"], state["sensitivity"] = lora_lib.adalora_update_mask(
                adapters, _tree_like(adapters, named), state["sensitivity"],
                state["rank_mask"], step_no, cfg.max_steps, cfg.lora)
        for _, p in leaves(adapters):
            p.grad = None
        return metrics

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        metrics = (peft_step if cfg.mode == "peft" else full_step)(state, batch)
        state["step"] += 1
        return metrics
    return step


def make_eval_loss_step(model_cfg: WhisperConfig, cfg: TrainStepConfig):
    """batch → {"loss", "tokens"} without gradients (PEFT: the state's
    adapters, rank-masked, no dropout)."""
    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, n, _ = loss_fn(state["params"], batch, model_cfg, cfg,
                                 state.get("adapters"), state.get("rank_mask"))
        return {"loss": loss, "tokens": n}
    return step

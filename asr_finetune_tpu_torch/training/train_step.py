"""The training step, full fine-tuning and PEFT (PyTorch port).

Counterpart of asr_finetune_tpu/training/train_step.py (`make_train_state`
:61, `make_loss_fn` :83, `make_train_step` :129, `make_eval_loss_step`
:245):

- the loss: log-mel on the device from raw audio (when the batch carries
  "audio"; a batch of host features, --host_logmel or parquet, carries
  "mel"), in training SpecAugment on those features (`spec_augment`,
  ops/spec_augment.py; the eval loss never masks, as the JAX eval passes
  no rng), the teacher-forced forward in the compute dtype, then the fused
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

Data parallelism (parallel/, one process per card in a group): each data
rank runs its rows of the global batch. The loss is the token mean over
the global (micro)batch, as the JAX loss over a sharded batch is: the data
ranks sum their microbatch token counts first, each back-propagates its
share local_sum / global_tokens, and the gradients are summed over the
data group, so `grad_norm`, the clip and AdaLoRA's mask update see the
reduced gradients on every rank. AdaLoRA's orth_reg enters the gradients
once (global rank 0's). Lora dropout and SpecAugment draw the global
batch's masks and keep the data rank's rows (models/whisper.LoraDropout),
so two ranks mask as one process does. W8A8's dynamic outlier form ranks
its columns over the global batch too (`split_rows`). The metrics are the
global batch's.

Tensor parallelism (--tp; parallel/mesh.py, models/whisper.py): the ranks
of a model group read the same rows and each computes the same loss over
its slice of the model. In full fine-tuning a split leaf's gradient is
whole on its rank, and a whole leaf's comes out the same on every rank of
the group: neither is summed over it, and `grad_norm` counts each split
leaf's slices once each (optim.global_norm). In PEFT each rank's adapter
gradients are its part (its columns of b, its share of a's and e's), so
they are summed over the model group as well as the data group.

ZeRO and offload (parallel/sharding.py, `Placement`): each rank holds the
AdamW moments of its slice of every split leaf (`opt_state["shards"]`),
updates that slice and gathers the whole leaf back, so every rank holds
the same parameters (or adapters); the moments may live in pinned host
memory between steps, and a PEFT run's frozen base too, copied to the card
for the step.

Random streams: each micro-batch i of step s draws from its own
generators, seeded by (seed, s * accum_steps + i, site), as the JAX step
folds the step into its key and splits it over micro-batches: SpecAugment
at site "spec_augment", lora dropout at each projection's site.

Metrics stay on the device: the trainer fetches a whole logging window at
once.

Spans (utils/profiling.py, recorded while the recorder is on): `train.fwd`
and `train.bwd` for each microbatch's loss and its backward (remat's
recompute included; then the loss and token sums, whose first copy of a
host scalar to the card waits for the card), `train.update` from the
gradients to the step's return (the group's reduce, the norm, the clip,
AdamW, the ZeRO gather, AdaLoRA's mask update inside as `train.adalora`,
the gradients cleared).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models import unimoe
from ..models import whisper as W
from ..models.configs import WhisperConfig
from ..ops import logmel as logmel_ops
from ..ops.fused_ce import fused_cross_entropy
from ..ops.quant import QuantConfig
from ..ops.spec_augment import spec_augment
from ..parallel import mesh
from ..parallel.sharding import Placement, is_split
from ..utils import profiling
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
    on_device_logmel: bool = False      # train batches carry "audio", not "mel"
    spec_augment: bool = False          # mask the training features (not eval)
    n_mels: int = 80
    attn_impl: str = "auto"             # encoder: the attention kernel
    decoder_attn_impl: str = "xla"      # causal self-attention stays plain;
                                        # cross-attention is promoted to auto
    fused_ce: bool = True               # chunked CE; (B, T, V) logits never exist
    max_steps: int = 10000              # AdaLoRA's budget schedule
    lora: Optional[lora_lib.LoraConfig] = None
    seed: int = 0                       # base of the SpecAugment and dropout streams
    quant: Optional[QuantConfig] = None  # how int8 base weights are multiplied
    fused_qkv: bool = True              # the encoder may take the fused-qkv path
                                        # where ASR_TPU_FUSED_QKV engages it


def make_train_state(params: Params, opt: AdamW, adapters: Optional[Params] = None,
                     adalora: bool = False,
                     placement: Optional[Placement] = None) -> Dict[str, Any]:
    """Full fine-tuning: {"step", "params", "opt_state"}, the fp32 masters
    made leaves that require grad, in place in the tree. PEFT (adapters
    given): also "adapters" (fp32, every leaf requiring grad; the base is
    left as it is) and under AdaLoRA "sensitivity" and "rank_mask". The
    optimizer state holds moments for this rank's part ("shards") of the
    leaves `opt.trainable` picks, where `placement` keeps them (default:
    beside the leaves), their paths under "names" and under "tp_split"
    whether each is a tensor-parallel slice (full fine-tuning under tp)."""
    placement = placement or Placement()
    tree = params if adapters is None else adapters
    what = "full fine-tuning keeps fp32 master weights" if adapters is None \
        else "PEFT trains fp32 adapters"
    for _, p in leaves(tree):
        if p.dtype != torch.float32:
            raise TypeError(f"{what}, got a {p.dtype} leaf")
        p.requires_grad_(True)
    trained = opt.trainable(tree)
    shards = placement.leaf_shards([p for _, p in trained])
    opt_state = opt.init([s.of(p) for s, (_, p) in zip(shards, trained)],
                         zeros=placement.moment_zeros)
    opt_state["names"] = [k for k, _ in trained]
    opt_state["shards"] = shards
    opt_state["tp_split"] = [adapters is None and is_split(k, p.dim()) for k, p in trained]
    state = {"step": 0, "params": params, "opt_state": opt_state}
    if adapters is not None:
        state["adapters"] = adapters
        if adalora:
            state["sensitivity"] = lora_lib.init_sensitivity(adapters)
            state["rank_mask"] = lora_lib.init_rank_mask(adapters)
    return state


def _get_mel(batch: Dict[str, torch.Tensor], cfg: TrainStepConfig) -> torch.Tensor:
    """The JAX `_get_mel`: the device log-mel of "audio" under
    on_device_logmel, else the batch's "mel". A batch that carries only the
    other kind, the validation set of a mixed data mode (val_parquet,
    parquet_h5, val_h5: the JAX eval raises KeyError there), is read as it
    comes."""
    if "audio" in batch and (cfg.on_device_logmel or "mel" not in batch):
        with torch.no_grad():
            return logmel_ops.log_mel_spectrogram(batch["audio"], n_mels=cfg.n_mels)
    return batch["mel"]


def spec_augment_stream(seed: int, stream: int, row0: int = 0,
                        rows: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    """mel → SpecAugment'ed mel, the masks drawn on mel's device from the
    generator of (seed, stream, "spec_augment"); with rows > 0 those of
    rows [row0, row0 + B) of a global batch of `rows`."""
    def augment(mel: torch.Tensor) -> torch.Tensor:
        g = W.site_generator(seed, stream, "spec_augment", mel.device)
        return spec_augment(g, mel, rows=rows, row0=row0)
    return augment


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            model_cfg: WhisperConfig, cfg: TrainStepConfig,
            adapters: Optional[Params] = None, rank_mask: Optional[Params] = None,
            dropout: Optional[W.LoraDropout] = None,
            augment: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(mean token loss, num_tokens, orth_reg or None) of one (micro)batch.
    PEFT: `adapters` with `rank_mask` applied to e in the forward. augment:
    SpecAugment of the features (`spec_augment_stream`), in training. A
    Uni-MoE config (models/unimoe.py) runs its audio LM: the loss covers the
    labels, the transcript and end-token positions after the audio tokens,
    through its untied head."""
    peft = cfg.mode == "peft"
    if peft:
        adapters = lora_lib.apply_rank_mask(adapters, rank_mask)
    mel = _get_mel(batch, cfg)
    if augment is not None:
        mel = augment(mel)
    if unimoe.is_unimoe(model_cfg):
        # the LM's hidden states of the text positions, the untied head
        out = unimoe.forward(params, mel, batch["decoder_input_ids"].long(), model_cfg,
                             compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                             attn_impl=cfg.attn_impl, adapters=adapters if peft else None,
                             dropout=dropout, quant=cfg.quant, fused_qkv=cfg.fused_qkv)
        loss, n = fused_cross_entropy(out, params["lm"]["head"], batch["labels"],
                                      cfg.label_smoothing, embed_grad=not peft)
        return loss, n, _orth_reg(adapters, cfg)
    out = W.forward(params, mel, batch["decoder_input_ids"].long(), model_cfg,
                    compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                    attn_impl=cfg.attn_impl,
                    decoder_attn_impl=cfg.decoder_attn_impl,
                    return_hidden=cfg.fused_ce,
                    # under tp, this rank's columns of each b
                    adapters=lora_lib.tp_local(adapters) if peft else None,
                    dropout=dropout,
                    quant=cfg.quant, fused_qkv=cfg.fused_qkv)
    if cfg.fused_ce:
        loss, n = fused_cross_entropy(out, params["decoder"]["embed"],
                                      batch["labels"], cfg.label_smoothing,
                                      embed_grad=not peft)
    else:
        loss, n = W.cross_entropy(out, batch["labels"], cfg.label_smoothing)
    return loss, n, _orth_reg(adapters, cfg)


def _orth_reg(adapters: Optional[Params], cfg: TrainStepConfig) -> Optional[torch.Tensor]:
    """AdaLoRA's orthogonality regulariser of the (rank-masked) adapters, or
    None outside AdaLoRA."""
    lcfg = cfg.lora
    if cfg.mode == "peft" and lcfg is not None and lcfg.adalora and lcfg.orth_reg_weight > 0:
        return lora_lib.orth_regularizer(adapters, lcfg.orth_reg_weight)
    return None


def split_rows(cfg: TrainStepConfig) -> TrainStepConfig:
    """cfg for a forward over this data rank's rows of a batch split over
    the data group: its W8A8 products rank their dynamic outlier columns
    over the whole batch (ops/quant.QuantConfig.rows_split). cfg itself in
    one process or without an int8 base."""
    if cfg.quant is None or mesh.data_world() == 1:
        return cfg
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, rows_split=True))


def compute_grads(params: Params, batch: Dict[str, torch.Tensor],
                  model_cfg: WhisperConfig, cfg: TrainStepConfig,
                  adapters: Optional[Params] = None,
                  rank_mask: Optional[Params] = None, step: Optional[int] = None
                  ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Gradients of the loss (plus orth_reg) on every leaf of the params
    (full) or of the adapters (PEFT), in `leaves` order and averaged over
    microbatches, and the step's metrics. With `step`, SpecAugment (when
    the config asks for it) and PEFT's lora dropout (at a rate above 0)
    draw their masks, one stream per microbatch. In a
    group of more than one rank, `batch` is this data rank's rows of the global batch and
    the gradients and metrics are the global batch's (module docstring)."""
    return _reduce_grads(cfg, *_backprop(params, batch, model_cfg, cfg, adapters,
                                         rank_mask, step))


def _backprop(params: Params, batch: Dict[str, torch.Tensor], model_cfg: WhisperConfig,
              cfg: TrainStepConfig, adapters: Optional[Params] = None,
              rank_mask: Optional[Params] = None, step: Optional[int] = None):
    """compute_grads' forward and backward of each microbatch (spans
    `train.fwd`, `train.bwd`, the latter with the microbatch's sums): the
    differentiated leaves, holding this rank's gradient sums in `.grad`,
    and the sums of the loss, the tokens and orth_reg."""
    peft = cfg.mode == "peft"
    cfg = split_rows(cfg)
    ps = [p for _, p in leaves(adapters if peft else params)]
    for p in ps:
        p.grad = None
    n_micro = cfg.accum_steps
    micro = ([batch] if n_micro == 1 else
             [{k: v[i] for k, v in batch.items()} for i in range(n_micro)])
    dp = mesh.world() > 1
    if dp:
        rank, world = mesh.data_rank(), mesh.data_world()
        local_n = torch.stack([(mb["labels"] != W.IGNORE_ID).sum() for mb in micro])
        global_n = mesh.all_reduce_sum_(local_n.clone(), over="data")
        share = local_n / global_n.clamp(min=1)
    loss_sum = torch.zeros((), dtype=torch.float32)
    tok_sum = torch.zeros((), dtype=torch.long)
    reg_sum = None
    for i, mb in enumerate(micro):
        with profiling.span("train.fwd"):
            dropout = augment = None
            if step is not None:
                stream, rows = step * n_micro + i, mb["labels"].shape[0]
                by_row = dict(row0=rank * rows, rows=world * rows) if dp else {}
                if peft and cfg.lora is not None and cfg.lora.dropout > 0:
                    dropout = W.LoraDropout(cfg.lora.dropout, cfg.seed, stream, **by_row)
                if cfg.spec_augment:
                    augment = spec_augment_stream(cfg.seed, stream, **by_row)
            loss, n, reg = loss_fn(params, mb, model_cfg, cfg, adapters, rank_mask, dropout,
                                   augment)
            if dp:
                loss = loss * share[i]      # this rank's part of the global mean
                n = global_n[i]
        # orth_reg enters the gradients summed over the ranks once: rank 0's
        with_reg = reg is not None and not (dp and mesh.rank())
        with profiling.span("train.bwd"):
            (loss + reg if with_reg else loss).backward()
            loss_sum = loss_sum.to(loss.device) + loss.detach()
            tok_sum = tok_sum.to(n.device) + n
            if reg is not None:
                reg_sum = reg.detach() if reg_sum is None else reg_sum + reg.detach()
    return ps, loss_sum, tok_sum, reg_sum


def _reduce_grads(cfg: TrainStepConfig, ps: List[torch.Tensor], loss_sum: torch.Tensor,
                  tok_sum: torch.Tensor, reg_sum: Optional[torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """compute_grads' end: the gradients summed over the group and averaged
    over the microbatches, and the metrics."""
    n_micro = cfg.accum_steps
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
    if mesh.world() > 1:
        # PEFT: each rank of a model group holds a part of each gradient
        over = "world" if cfg.mode == "peft" else "data"
        for g in grads:
            mesh.all_reduce_sum_(g, over=over)
        mesh.all_reduce_sum_(loss_sum, over="data")
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


def _update(opt: AdamW, params: List[torch.Tensor], grads: List[torch.Tensor],
            opt_state: Dict[str, Any]) -> torch.Tensor:
    """AdamW over this rank's slice of each leaf (ZeRO; the whole leaf when
    unsplit), clipped by the norm of the whole gradients, then each split
    leaf gathered whole on every rank. Returns that norm."""
    shards = opt_state["shards"]
    norm = global_norm(grads, opt_state.get("tp_split"))
    opt.step([s.of(p) for s, p in zip(shards, params)],
             [s.of(g) for s, g in zip(shards, grads)], opt_state, norm=norm)
    for s, p in zip(shards, params):
        s.gather_(p)
    return norm


def make_train_step(model_cfg: WhisperConfig, opt: AdamW, cfg: TrainStepConfig,
                    placement: Optional[Placement] = None):
    """Returns step(state, batch) → metrics; the state is updated in place.
    `placement` says where the frozen base lives between steps (default:
    on the device, as given)."""
    placement = placement or Placement()

    def full_step(state, batch):
        params = state["params"]
        sums = _backprop(params, batch, model_cfg, cfg, step=state["step"])
        with profiling.span("train.update"):
            grads, metrics = _reduce_grads(cfg, *sums)
            metrics["grad_norm"] = _update(opt, [p for _, p in leaves(params)], grads,
                                           state["opt_state"])
            for _, p in leaves(params):
                p.grad = None
        return metrics

    def peft_step(state, batch):
        adapters, step_no = state["adapters"], state["step"]
        sums = _backprop(placement.base_on_device(state["params"]), batch, model_cfg, cfg,
                         adapters, state.get("rank_mask"), step_no)
        with profiling.span("train.update"):
            grads, metrics = _reduce_grads(cfg, *sums)
            named = dict(zip((k for k, _ in leaves(adapters)), grads))
            metrics["grad_norm"] = global_norm(grads)
            adalora = cfg.lora is not None and cfg.lora.adalora and "sensitivity" in state
            trained = opt.trainable(adapters)
            # the update clips its gradients in place; the mask update reads the
            # unclipped ones (the adapters are small)
            tg = [named[k].clone() if adalora else named[k] for k, _ in trained]
            _update(opt, [p for _, p in trained], tg, state["opt_state"])
            if adalora:
                with profiling.span("train.adalora"):
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


def make_eval_loss_step(model_cfg: WhisperConfig, cfg: TrainStepConfig,
                        rows_of_batch: bool = False):
    """batch → {"loss", "tokens"} without gradients (PEFT: the state's
    adapters, rank-masked, no dropout; no SpecAugment), on this process's
    batch alone: the trainer reduces an evaluation over the ranks.
    rows_of_batch: the batch is this data rank's rows of one split over the
    data group (`split_rows`), as the trainer's evaluation is."""
    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, n, _ = loss_fn(state["params"], batch, model_cfg,
                                 split_rows(cfg) if rows_of_batch else cfg,
                                 state.get("adapters"), state.get("rank_mask"))
        return {"loss": loss, "tokens": n}
    return step

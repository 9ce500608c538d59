"""AdamW with warmup schedules and global-norm clipping (PyTorch port).

Counterpart of asr_finetune_tpu/training/optim.py, full fine-tuning: the
optax chain clip_by_global_norm(max_grad_norm) → adamw(schedule, b1 0.9,
b2 0.98, eps 1e-8, weight_decay) of `make_optimizer` (:65), written out so
the arithmetic is optax's own:

- the schedule (`make_lr_schedule`, :41): linear | cosine | constant decay
  to 0 after a linear warmup from 0, evaluated at the number of updates
  already applied, so the first update uses schedule(0) (0 with warmup);
- clipping: when ‖g‖ >= max_norm every gradient becomes (g / ‖g‖) ·
  max_norm (no epsilon, unlike torch.nn.utils.clip_grad_norm_);
- Adam: mu = b1 mu + (1-b1) g, nu = b2 nu + (1-b2) g², bias-corrected by
  1 - b^count, update = mu_hat / (sqrt(nu_hat) + eps), plus weight_decay ·
  param (decoupled), times -lr, added to the fp32 master in place.

The moments are fp32 tensors beside the parameters, or in pinned host
memory (--offload_optimizer, parallel/sharding.py): a moment held on
another device than its parameter is copied to it for the leaf's update
and back after it, asynchronously. The update runs leaf by leaf (the
stacked tree has a few dozen leaves), so its scratch, and what an
offloaded state puts on the card, is a few copies of the largest leaf,
not of the model; the clip factor stays on the device (no host sync).
Under ZeRO (parallel/sharding.py) each rank passes its slices of the
parameters and gradients, and the norm of the whole gradients.

PEFT (`adapter_freeze_mask`, :22, and `make_optimizer(trainable_mask=...)`,
:84-89, optax.multi_transform with set_to_zero): the optimizer updates only
the leaves the mask marks trained (`AdamW.trainable`); a frozen leaf (the
adapters' `scaling`, plain LoRA's `e`) gets no update, no weight decay, no
moments and no share of the clip norm.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..parallel import mesh

Schedule = Callable[[int], float]


def leaves(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf of a nested dict, in a fixed order (sorted
    keys; paths "/"-joined)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}/{k}" if prefix else k
        out.extend(leaves(v, key) if isinstance(v, dict) else [(key, v)])
    return out


def adapter_freeze_mask(adapters: Dict[str, Any], adalora: bool) -> Dict[str, Any]:
    """Trainability mask of an adapter tree (True = trained): `scaling` is
    the constant alpha / rank, and `e` trains only under AdaLoRA."""
    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = not (k == "scaling" or (k == "e" and not adalora))
        return out
    return walk(adapters)


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init → end over `steps`, then held."""
    if steps <= 0:
        return lambda count: init

    def sched(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end
    return sched


def _cosine(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0."""
    def sched(count: int) -> float:
        c = min(count, steps)
        return init * 0.5 * (1 + math.cos(math.pi * c / steps))
    return sched


def make_lr_schedule(learning_rate: float, max_steps: int,
                     scheduler: str = "linear",
                     warmup_steps: Optional[int] = None,
                     warmup_ratio: Optional[float] = None) -> Schedule:
    """linear|cosine|constant decay to 0 with linear warmup."""
    if warmup_steps is None:
        warmup_steps = int(round((warmup_ratio or 0.0) * max_steps))
    warmup_steps = min(warmup_steps, max_steps)

    warmup = _linear(0.0, learning_rate, max(warmup_steps, 1))
    decay_steps = max(max_steps - warmup_steps, 1)
    if scheduler == "linear":
        decay = _linear(learning_rate, 0.0, decay_steps)
    elif scheduler == "cosine":
        decay = _cosine(learning_rate, decay_steps)
    elif scheduler == "constant":
        decay = lambda count: learning_rate  # noqa: E731
    else:
        raise ValueError(f"unknown lr scheduler {scheduler!r}")
    if warmup_steps == 0:
        return decay
    return lambda count: (warmup(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def global_norm(grads: List[torch.Tensor],
                split: Optional[List[bool]] = None) -> torch.Tensor:
    """sqrt of the sum of squares over all gradients, fp32 (optax.global_norm).
    split (tensor parallelism): per gradient, whether it is this rank's
    slice of a leaf split over the model group. Their squares are summed
    over the group and the whole leaves' counted once, so every rank gets
    the norm of the whole gradients."""
    norms = torch._foreach_norm([g.float() for g in grads])
    if not split or not any(split):
        return torch.sqrt(sum(n * n for n in norms))
    parts = torch.stack([n * n for n, s in zip(norms, split) if s]).sum()
    whole = sum(n * n for n, s in zip(norms, split) if not s)
    return torch.sqrt(whole + mesh.all_reduce_sum_(parts, over="model"))


class AdamW:
    """AdamW over a flat list of fp32 parameters, optax's arithmetic."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0,
                 trainable_mask: Optional[Dict[str, Any]] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.trainable_mask = trainable_mask

    def trainable(self, tree: Dict[str, Any]) -> List[Tuple[str, torch.Tensor]]:
        """(path, leaf) of every leaf of `tree` this optimizer updates, in
        sorted-path order: all of them, or those the trainable mask marks."""
        pairs = leaves(tree)
        if self.trainable_mask is None:
            return pairs
        keep = dict(leaves(self.trainable_mask))
        return [(k, t) for k, t in pairs if keep[k]]

    def init(self, params: List[torch.Tensor],
             zeros: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> Dict[str, object]:
        """{"count": updates applied, "mu", "nu": fp32 zeros like params};
        `zeros(p)` makes each moment (default: beside p)."""
        zeros = zeros or (lambda p: torch.zeros_like(p, dtype=torch.float32))
        return {"count": 0, "mu": [zeros(p) for p in params],
                "nu": [zeros(p) for p in params]}

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: Dict[str, object], norm: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """Clip `grads` in place, update the moments and apply the update to
        `params` in place; returns the pre-clip global gradient norm, that
        of `grads` or the given `norm` (params and grads are then slices of
        the leaves whose gradients it measured)."""
        g_norm = global_norm(grads) if norm is None else norm
        div = mul = None
        if self.max_grad_norm and self.max_grad_norm > 0:
            # optax: select(norm < max, g, (g / norm) * max); the unclipped
            # branch divides and multiplies by 1, exactly
            keep = g_norm < self.max_grad_norm
            one = torch.ones_like(g_norm)
            div = torch.where(keep, one, g_norm)
            mul = torch.where(keep, one, torch.full_like(g_norm,
                                                         self.max_grad_norm))
        lr = self.schedule(int(state["count"]))
        count = int(state["count"]) + 1
        bc1, bc2 = 1 - self.b1 ** count, 1 - self.b2 ** count
        for p, g, held_mu, held_nu in zip(params, grads, state["mu"], state["nu"]):
            staged = held_mu.device != p.device
            mu, nu = ((held_mu.to(p.device, non_blocking=True),
                       held_nu.to(p.device, non_blocking=True)) if staged
                      else (held_mu, held_nu))
            if div is not None:
                g.div_(div).mul_(mul)
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)
            if staged:
                # back to the host on the same stream: the next use, a copy
                # to the card or a checkpoint after a synchronize, sees it
                held_mu.copy_(mu, non_blocking=True)
                held_nu.copy_(nu, non_blocking=True)
        state["count"] = count
        return g_norm


def make_optimizer(learning_rate: float, max_steps: int,
                   scheduler: str = "linear",
                   warmup_steps: Optional[int] = None,
                   warmup_ratio: Optional[float] = None,
                   weight_decay: float = 0.0,
                   adam_beta1: float = 0.9,
                   adam_beta2: float = 0.98,
                   adam_eps: float = 1e-8,
                   max_grad_norm: float = 1.0,
                   trainable_mask: Optional[Dict[str, Any]] = None) -> AdamW:
    sched = make_lr_schedule(learning_rate, max_steps, scheduler,
                             warmup_steps, warmup_ratio)
    return AdamW(sched, adam_beta1, adam_beta2, adam_eps, weight_decay,
                 max_grad_norm, trainable_mask)

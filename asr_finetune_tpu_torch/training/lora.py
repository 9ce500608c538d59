"""LoRA / AdaLoRA adapter trees (PyTorch port).

Counterpart of asr_finetune_tpu/training/lora.py (:35-283): the adapters are
a tree of their own beside the frozen base, threaded through the model's
layer loops (models/whisper.py `dense`). Each adapter stack holds the
SVD-style triple (a, e, b) for L layers: delta(x) = scaling · ((x @ a) · e) @ b,
plain LoRA when e is all ones and frozen, AdaLoRA's form when e is trained
and masked for rank pruning. AdaLoRA's budget follows the paper: the
importance of triplet i is the smoothed sensitivity |p · g| of its a column,
b row and e entry; the global average rank is annealed cubically from init_r
to target_r between tinit and tfinal and re-allocated every delta_t steps, by
masking (fixed shapes), never by resizing.

Every tree walk here visits keys in sorted order, so the importance rows of
`adalora_update_mask` and the mask it builds pair up whatever order a tree's
dicts were built in.

Under tensor parallelism (--tp) the adapters stay whole on every rank (JAX
`adapter_shardings`): the ranking, the rank masks, the orthogonality
penalty and the checkpoints are those of one process. Only the forward
reads a part: each q/v delta is made for the rank's output columns of the
projection, from the columns of b the rank holds (`tp_local`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.configs import UniMoEConfig
from ..parallel import mesh
from .optim import leaves

Params = Dict[str, Any]

# which projections get adapters, per attention block (reference:
# target_modules=["q_proj", "v_proj"])
TARGETS = ("q", "v")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8                 # init_r
    alpha: float = 16.0           # lora_alpha
    dropout: float = 0.05
    adalora: bool = False
    target_rank: Optional[int] = None   # AdaLoRA final average rank
    tinit_frac: float = 0.1
    tfinal_frac: float = 0.8
    delta_t: int = 10
    orth_reg_weight: float = 0.8
    beta1: float = 0.85           # sensitivity EMA
    beta2: float = 0.85

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _init_adapter(g: torch.Generator, L: int, d_in: int, d_out: int,
                  cfg: LoraConfig, device) -> Params:
    """One adapter stack for L layers: a ~ N(0, 0.02), b = 0 (the delta
    starts at zero), e = 1, scaling = alpha / rank."""
    r = cfg.rank
    return {
        "a": torch.randn((L, d_in, r), generator=g, device=device) * 0.02,
        "e": torch.ones((L, 1, r), device=device),
        "b": torch.zeros((L, r, d_out), device=device),
        "scaling": torch.full((L,), cfg.scaling, device=device),
    }


def init_adapters(g: torch.Generator, model_cfg, cfg: LoraConfig,
                  encoder: bool = False, device="cpu") -> Params:
    """The adapter tree models/whisper.py reads: decoder self and cross
    attention q/v, and with encoder=True (--lora_targets all) the encoder's
    self-attention q/v too. `g` draws every `a`, in a fixed order; the
    numbers differ from the JAX package's (jax.random). For Uni-MoE
    (models/unimoe.py) the LM's q (d → d) and v (d → its KV width) under
    "lm" take the decoder's place, beside the Whisper encoder's."""
    if isinstance(model_cfg, UniMoEConfig):
        d, L = model_cfg.hidden_size, model_cfg.num_hidden_layers
        kv = model_cfg.num_key_value_heads * model_cfg.head_dim
        out: Params = {"lm": {"q": _init_adapter(g, L, d, d, cfg, device),
                              "v": _init_adapter(g, L, d, kv, cfg, device)}}
        model_cfg = model_cfg.encoder
    else:
        d, Ld = model_cfg.d_model, model_cfg.decoder_layers
        out = {"decoder": {
            blk: {t: _init_adapter(g, Ld, d, d, cfg, device) for t in TARGETS}
            for blk in ("self_attn", "cross_attn")}}
    if encoder:
        de, Le = model_cfg.d_model, model_cfg.encoder_layers
        out["encoder"] = {t: _init_adapter(g, Le, de, de, cfg, device) for t in TARGETS}
    return out


def _is_adapter(node) -> bool:
    return isinstance(node, dict) and "a" in node and "e" in node


def tp_local(adapters: Optional[Params]) -> Optional[Params]:
    """The adapters as this rank's forward reads them under tp: every b
    (L, r, d_out) narrowed to the rank's d_out / tp columns of its (column
    split) projection, a view, so the gradient lands in those columns of
    the whole b; the adapters themselves at tp 1."""
    tp = mesh.model_world()
    if adapters is None or tp == 1:
        return adapters
    r = mesh.model_rank()

    def walk(ad):
        if _is_adapter(ad):
            n = ad["b"].shape[-1] // tp
            return {**ad, "b": ad["b"].narrow(-1, r * n, n)}
        return {k: walk(v) for k, v in ad.items()}
    return walk(adapters)


def _adapter_stacks(tree: Params, prefix: str = "") -> List[Tuple[str, Params]]:
    """(path, adapter dict) of every adapter stack, keys sorted."""
    if _is_adapter(tree):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(_adapter_stacks(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def num_adapter_params(adapters: Params) -> int:
    """Elements over every tensor of an adapter tree."""
    return sum(t.numel() for _, t in leaves(adapters))


def _map(fn, *trees):
    """fn over the leaves of trees of one structure; a new tree."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


# ---------------------------------------------------------------------------
# AdaLoRA: budget schedule + sensitivity-based rank masking
# ---------------------------------------------------------------------------

def rank_budget(step: int, max_steps: int, cfg: LoraConfig) -> np.float32:
    """Global average-rank budget b(t): init_r → target_r, cubic anneal
    between tinit and tfinal (AdaLoRA eq. 7), in float32 as the JAX
    function computes it."""
    target = cfg.target_rank if cfg.target_rank is not None else max(cfg.rank // 2, 1)
    tinit = int(cfg.tinit_frac * max_steps)
    tfinal = int(cfg.tfinal_frac * max_steps)
    if step < tinit:
        return np.float32(cfg.rank)
    span = max(tfinal - tinit, 1)
    f32 = np.float32
    frac = np.clip(f32(step - tinit) / f32(span), f32(0.0), f32(1.0))
    t = f32(1.0) - frac
    return f32(target) + f32(cfg.rank - target) * ((t * t) * t)


def init_sensitivity(adapters: Params) -> Params:
    return _map(lambda t: torch.zeros_like(t.detach()), adapters)


def init_rank_mask(adapters: Params) -> Params:
    """All-ones rank mask, one (L, 1, r) tensor per adapter stack."""
    def walk(ad):
        if _is_adapter(ad):
            return torch.ones_like(ad["e"].detach())
        return {k: walk(v) for k, v in ad.items()}
    return walk(adapters)


def apply_rank_mask(adapters: Params, mask: Optional[Params]) -> Params:
    """Non-destructive rank pruning: e times the mask in the forward only;
    the stored e is untouched, so a pruned triplet can be re-admitted."""
    if mask is None:
        return adapters

    def walk(ad, m):
        if _is_adapter(ad):
            return {**ad, "e": ad["e"] * m}
        return {k: walk(ad[k], m[k]) for k in ad}
    return walk(adapters, mask)


@torch.no_grad()
def adalora_update_mask(adapters: Params, grads: Params, sens: Params,
                        mask: Params, step: int, max_steps: int,
                        cfg: LoraConfig) -> Tuple[Params, Params]:
    """The smoothed sensitivity beta1·s + (1 - beta1)·|p·g| of every leaf
    (always), and every delta_t steps a new rank mask that keeps the
    globally top round(budget · n_adapters · L) triplets by importance
    (mean sensitivity of the a column and b row, plus e's): a fixed-shape
    sort and threshold. Returns (new_rank_mask, new_sensitivity); the
    adapters are untouched."""
    b1 = cfg.beta1
    new_sens = _map(lambda s, p, g: b1 * s + (1 - b1) * (p.detach() * g).abs(),
                    sens, adapters, grads)
    stacks = _adapter_stacks(new_sens)
    imps = [s["a"].mean(dim=1) + s["b"].mean(dim=2) + s["e"][:, 0, :]
            for _, s in stacks]                                  # (L, r) each
    if step % cfg.delta_t != 0:
        return mask, new_sens
    n_ad, L = len(imps), imps[0].shape[0]
    budget = rank_budget(step, max_steps, cfg)
    if all(i.shape[0] == L for i in imps):
        k_total = int(np.round(budget * np.float32(n_ad) * np.float32(L)))
    else:       # stacks of other depths (an encoder beside an LM): the budget a layer
        k_total = int(np.round(budget * np.float32(sum(i.shape[0] for i in imps))))
    flat = torch.cat([i.reshape(-1) for i in imps])
    order = torch.sort(flat, descending=True).values
    thresh = order[min(max(k_total - 1, 0), flat.numel() - 1)]
    keep = (flat >= thresh).float()
    masks, off = {}, 0
    for (path, _), imp in zip(stacks, imps):
        masks[path] = keep[off: off + imp.numel()].view(imp.shape)[:, None, :]
        off += imp.numel()

    def build(m_old, prefix=""):
        if not isinstance(m_old, dict):
            return masks[prefix]
        return {k: build(v, f"{prefix}/{k}" if prefix else k) for k, v in m_old.items()}
    return build(mask), new_sens


def orth_regularizer(adapters: Params, weight: float) -> torch.Tensor:
    """AdaLoRA orthogonality penalty: ||AᵀA − I||² + ||BBᵀ − I||² per layer,
    averaged over layers and the two factors, times weight."""
    total, count = None, 0
    for _, ad in _adapter_stacks(adapters):
        a, b = ad["a"], ad["b"]                       # (L, d, r), (L, r, d)
        eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)
        ata = torch.matmul(a.transpose(1, 2), a)
        bbt = torch.matmul(b, b.transpose(1, 2))
        t = ((ata - eye) ** 2).sum() + ((bbt - eye) ** 2).sum()
        total = t if total is None else total + t
        count += a.shape[0] * 2
    if total is None:
        return torch.zeros(())
    return weight * total / max(count, 1)


@torch.no_grad()
def merge_adapters(params: Params, adapters: Optional[Params]) -> Params:
    """The base with the adapter deltas folded in: w' = w + scaling·(a⊙e)@b
    on every adapted projection (exact at inference, where lora dropout is
    off). An int8 base projection is dequantized to fp32 before its delta
    lands and stays fp32; the projections without adapters keep their form,
    so a merged int8 base is mixed (the decoder kernels take per-projection
    int8 flags). Returns a new tree sharing every untouched leaf."""
    if adapters is None:
        return params

    def delta(ad: Params) -> torch.Tensor:
        return torch.matmul(ad["a"] * ad["e"], ad["b"]) * ad["scaling"][:, None, None]

    def fold(wp: Params, ad: Params) -> Params:
        if "w_q8" in wp:
            w = wp["w_q8"].float() * wp["w_scale"].float()
        else:
            w = wp["w"]
        out = {k: v for k, v in wp.items() if k not in ("w_q8", "w_scale", "w_q8_nk")}
        out["w"] = w + delta(ad).to(w.dtype)
        return out

    merged = dict(params)
    if "encoder" in adapters:
        attn = dict(params["encoder"]["layers"]["attn"])
        for t, ad in adapters["encoder"].items():
            attn[t] = fold(attn[t], ad)
        merged["encoder"] = {**params["encoder"],
                             "layers": {**params["encoder"]["layers"], "attn": attn}}
    if "decoder" in adapters:
        layers = dict(params["decoder"]["layers"])
        for block, ads in adapters["decoder"].items():
            blk = dict(layers[block])
            for t, ad in ads.items():
                blk[t] = fold(blk[t], ad)
            layers[block] = blk
        merged["decoder"] = {**params["decoder"], "layers": layers}
    return merged

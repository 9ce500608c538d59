"""Tensor-parallel split of the model, ZeRO partition of the optimizer
state and host offload (counterpart of asr_finetune_tpu/parallel/sharding.py
`param_shardings` :31-66, `adapter_shardings` :69-72, `zero_shardings`
:75-100, `with_memory_kind` and `host_offload_shardings` :103-120).

- `tp_axis` is JAX's `param_shardings` rule, copied: the q/k/v and fc1
  weights (w, w_q8, their w_scale) and biases are split by output columns
  over the tensor-parallel ("model") group, the o and fc2 weights by input
  rows; the o/fc2 biases and w_scale, the embeddings, layer norms and convs
  stay whole, and so does a leaf whose dimension does not divide by tp.
  `split_tree` keeps each rank's slice, `gather_tree` makes the whole tree
  again (an all-gather over the model group). The adapters stay whole on
  every rank (JAX `adapter_shardings`). The port computes each rank's
  heads alone, so a model whose heads or d_ff do not divide by tp raises
  (`check_tensor_parallel`), where GSPMD would split inside a head.
- `zero_axis` is JAX's rule, copied: each optimizer-state leaf is split
  over the data group along its largest axis divisible by its size (JAX
  splits over "data" only; under tp the leaf is the rank's slice);
  leaves under 16384 elements, and leaves with no divisible axis, stay
  whole on every rank. A `LeafShard` is one rank's part of one leaf: AdamW
  updates that slice of the parameter from its moments' shard, and
  `gather_` then makes the whole parameter (or slice) again on every rank
  of the data group.
- `Placement` holds the offload choices: `offload_optimizer` keeps each
  moment shard in pinned host memory between steps (AdamW copies it to
  the card at use and back after the update, the JAX package's
  `offload_opt_state`); `offload_param` keeps a PEFT run's frozen base
  there, copied to the card for each step and each evaluation and never
  kept on it. On a CPU device the state already lives on the host: nothing
  moves and nothing is pinned.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..ops.quant import KMAJOR_KEY, ROW_SPLIT
from . import mesh

# the projections JAX splits by output columns (ROW_SPLIT: by input rows)
COLUMN_SPLIT = ("q", "k", "v", "fc1")


def _candidate(path: str, ndim: int) -> Optional[int]:
    """The axis JAX's rule would split the leaf at `path` along, before its
    divisibility check (`ok`), or None."""
    keys = path.split("/")
    name, parent = keys[-1], keys[-2] if len(keys) >= 2 else ""
    if parent in COLUMN_SPLIT:
        if name in ("w", "w_q8", "w_scale") and ndim == 3:
            return 2
        if name == "b" and ndim == 2:
            return 1
        if name == KMAJOR_KEY and ndim == 3:
            return 1
    if parent in ROW_SPLIT:
        if name in ("w", "w_q8") and ndim == 3:
            return 1
        if name == KMAJOR_KEY and ndim == 3:
            return 2
    return None


def is_split(path: str, ndim: int) -> bool:
    """Whether the leaf at `path` is a tensor-parallel slice in this run:
    tp > 1 and the rule splits it (`check_tensor_parallel` ensures every
    leaf the rule names divides)."""
    return mesh.model_world() > 1 and _candidate(path, ndim) is not None


def tp_axis(path: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The axis the whole leaf at `path` ("/"-joined keys) of `shape` is
    split along over tp ranks, or None (whole): JAX `param_shardings`."""
    axis = _candidate(path, len(shape))
    if axis is None or tp <= 1 or shape[axis] % tp:
        return None
    return axis


def check_tensor_parallel(cfg, tp: int) -> None:
    """Raise unless each rank can run whole heads and a whole share of the
    MLP: encoder and decoder heads and d_ff divisible by tp."""
    if tp <= 1:
        return
    bad = {k: getattr(cfg, k) for k in ("encoder_heads", "decoder_heads", "d_ff")
           if getattr(cfg, k) % tp}
    if bad:
        raise ValueError(f"--tp {tp}: each rank runs whole heads and a 1/tp share of "
                         f"the MLP, and {bad} do not divide by {tp}")


def _walk(tree: Dict[str, Any], fn, prefix: str = "") -> Dict[str, Any]:
    """A new tree of fn(path, leaf) at every leaf, visited in sorted order
    (every rank of a group meets the leaves, and their collectives, alike)."""
    out = {}
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}/{k}" if prefix else k
        out[k] = _walk(v, fn, path) if isinstance(v, dict) else fn(path, v)
    return {k: out[k] for k in tree}


def local_slice(path: str, t: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Model rank `rank`'s slice of the whole leaf `t` at `path` (a view),
    or t itself when the leaf stays whole."""
    axis = tp_axis(path, t.shape, tp)
    if axis is None:
        return t
    n = t.shape[axis] // tp
    return t.narrow(axis, rank * n, n)


def split_tree(tree: Dict[str, Any], model_rank: int, tp: int) -> Dict[str, Any]:
    """A new tree holding model rank `model_rank`'s slice of every split
    leaf (its own contiguous copy, so the whole leaf can be released) and
    the whole leaves as they are."""
    def part(path, t):
        s = local_slice(path, t, model_rank, tp)
        return t if s is t else s.contiguous().clone()
    return _walk(tree, part)


def gathered(path: str, t: torch.Tensor, host: bool = False) -> torch.Tensor:
    """The whole leaf of this rank's slice `t` at `path`: an all-gather over
    the model group (every rank of it calls this, leaf for leaf; with
    `host` into host memory), or t."""
    if not is_split(path, t.dim()):
        return t
    return mesh.all_gather(t, over="model", dim=_candidate(path, t.dim()), host=host)


def gather_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The whole tree from every model rank's `split_tree` slices (a new
    tree; the whole leaves are tree's own). `check_tensor_parallel` ensures
    every leaf the rule would split was split."""
    return _walk(tree, lambda path, t: gathered(path, t.detach()))

# JAX zero_shardings: leaves below ~64 KB of fp32 are not worth the traffic
MIN_SHARD_SIZE = 16384


def zero_axis(shape: Sequence[int], world: int) -> Optional[int]:
    """The axis a leaf of `shape` is split along over `world` ranks (the
    first of the largest axes divisible by world), or None: a scalar, fewer
    than MIN_SHARD_SIZE elements, or no divisible axis."""
    size = 1
    for s in shape:
        size *= s
    if len(shape) == 0 or size < MIN_SHARD_SIZE:
        return None
    best = None
    for i, s in enumerate(shape):
        if s % world == 0 and (best is None or s > shape[best]):
            best = i
    return best


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """One rank's part of an optimizer-state leaf of `shape`: a slice along
    `axis`, or the whole leaf (axis None)."""
    shape: Tuple[int, ...]
    axis: Optional[int] = None
    rank: int = 0
    world: int = 1

    @classmethod
    def of_shape(cls, shape: Sequence[int], rank: int, world: int) -> "LeafShard":
        shape = tuple(int(s) for s in shape)
        return cls(shape, zero_axis(shape, world) if world > 1 else None, rank, world)

    @property
    def length(self) -> int:
        return self.shape[self.axis] // self.world

    def of(self, t: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """The slice of a whole leaf `t` that rank (default this shard's)
        holds: a view."""
        if self.axis is None:
            return t
        r = self.rank if rank is None else rank
        return t.narrow(self.axis, r * self.length, self.length)

    @torch.no_grad()
    def gather_(self, t: torch.Tensor) -> torch.Tensor:
        """Make the whole leaf `t` on every rank of the data group from each
        rank's slice of it, in place: the other ranks' slices are zeroed and
        `t` summed over the group (x + 0 is x). Returns t."""
        if self.axis is None:
            return t
        for r in range(self.world):
            if r != self.rank:
                self.of(t, r).zero_()
        return mesh.all_reduce_sum_(t, over="data")

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every data rank's `part` (this rank's slice),
        on the device the collective runs on; `part` itself when unsplit."""
        if self.axis is None:
            return part
        full = torch.zeros(self.shape, dtype=part.dtype, device=mesh.comm_device(part))
        self.of(full).copy_(part)
        return mesh.all_reduce_sum_(full, over="data")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a training state lives between steps (module docstring)."""
    device: torch.device = torch.device("cpu")
    offload_optimizer: bool = False
    offload_param: bool = False

    @property
    def offloads(self) -> bool:
        """Whether anything leaves the card: on a CPU device nothing does."""
        return self.device.type == "cuda"

    def host(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of `t` in pinned host memory (on a CPU device: t)."""
        if not self.offloads:
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out

    def moment_zeros(self, p: torch.Tensor) -> torch.Tensor:
        """A zero fp32 moment shaped like `p`: pinned on the host under
        offload_optimizer, else beside p."""
        if self.offload_optimizer and self.offloads:
            return torch.zeros(p.shape, dtype=torch.float32, pin_memory=True)
        return torch.zeros_like(p, dtype=torch.float32)

    def leaf_shards(self, tensors: Sequence[torch.Tensor]) -> list:
        """This rank's LeafShard of each of its leaves (whole, or its
        tensor-parallel slice) over the data group."""
        return [LeafShard.of_shape(t.shape, mesh.data_rank(), mesh.data_world())
                for t in tensors]

    def base_to_host_(self, tree: Dict[str, Any]) -> None:
        """Move the frozen base into pinned host memory in place, leaf by
        leaf, each device copy released as its host copy replaces it; a
        no-op without offload_param."""
        if not (self.offload_param and self.offloads):
            return
        for k, v in tree.items():
            if isinstance(v, dict):
                self.base_to_host_(v)
            else:
                tree[k] = self.host(v)

    def base_on_device(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """The frozen base for one step or evaluation: a copy on the card of
        an offloaded base (asynchronous, from pinned memory), else `tree`."""
        if not (self.offload_param and self.offloads):
            return tree
        return {k: self.base_on_device(v) if isinstance(v, dict)
                else v.to(self.device, non_blocking=True) for k, v in tree.items()}

"""ZeRO partition of the optimizer state and host offload (counterpart of
asr_finetune_tpu/parallel/sharding.py `zero_shardings` :75-100,
`with_memory_kind` and `host_offload_shardings` :103-120).

- `zero_axis` is JAX's rule, copied: each optimizer-state leaf is split
  over the ranks along its largest axis divisible by the world size;
  leaves under 16384 elements, and leaves with no divisible axis, stay
  whole on every rank. A `LeafShard` is one rank's part of one leaf: AdamW
  updates that slice of the parameter from its moments' shard, and
  `gather_` then makes the whole parameter again on every rank.
- `Placement` holds the offload choices: `offload_optimizer` keeps each
  moment shard in pinned host memory between steps (AdamW copies it to
  the card at use and back after the update, the JAX package's
  `offload_opt_state`); `offload_param` keeps a PEFT run's frozen base
  there, copied to the card for each step and each evaluation and never
  kept on it. On a CPU device the state already lives on the host: nothing
  moves and nothing is pinned.

Tensor parallelism (`param_shardings`) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from . import mesh

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
        """Make the whole leaf `t` on every rank from each rank's slice of
        it, in place: the other ranks' slices are zeroed and `t` summed over
        the ranks (x + 0 is x). Returns t."""
        if self.axis is None:
            return t
        for r in range(self.world):
            if r != self.rank:
                self.of(t, r).zero_()
        return mesh.all_reduce_sum_(t)

    def gather(self, part: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's `part` (this rank's slice), on
        the device the collective runs on; `part` itself when unsplit."""
        if self.axis is None:
            return part
        full = torch.zeros(self.shape, dtype=part.dtype, device=mesh.comm_device(part))
        self.of(full).copy_(part)
        return mesh.all_reduce_sum_(full)


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
        """This rank's LeafShard of each (whole) leaf."""
        return [LeafShard.of_shape(t.shape, mesh.rank(), mesh.world()) for t in tensors]

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

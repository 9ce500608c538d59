"""The process group of data- and tensor-parallel training (counterpart
of asr_finetune_tpu/parallel/mesh.py `initialize_distributed` :31-42 and
`create_mesh` :46-61).

One process per card, PyTorch's way; the JAX package instead runs one
process per host over all its chips. A process learns its place from its
environment (`launch_from_env`):
- torchrun: RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and the
  rendezvous at MASTER_ADDR:MASTER_PORT;
- the JAX names COORDINATOR_ADDRESS or `ip_head` (host:port, the
  rendezvous) with RANK and WORLD_SIZE, or under Slurm with SLURM_PROCID,
  SLURM_NTASKS, SLURM_LOCALID and SLURM_NTASKS_PER_NODE;
- none of these: one process, no group, and every collective below is the
  identity.

`initialize` joins the group (NCCL when each rank of a host has a card
of its own, gloo on the CPU and when ranks share a card) and pins the
rank's card, `cuda:<local_rank % device_count>`. There is no fallback: a
rank that cannot reach its card, a group that fails to form and a failed
collective all raise.

The layout (`set_tensor_parallel`, --tp): world = data x tp, rank r at
data index r // tp and model index r % tp, JAX's row-major
`create_device_mesh((data, model))`. A tensor-parallel ("model") group is
tp consecutive ranks, which read the same batch rows; a data group is the
ranks of one model index. Without --tp > 1 the data group is the world
and the model group is this rank alone. The collectives take the group
they run over by name, `over` "world", "data" or "model"; over a group of
one rank they do nothing.

Trial packing (`trial_groups`, the HPO controller's --chips_per_trial;
JAX hpo/controller.py:119-146): the ranks of one host are split into
slots of chips_per_trial consecutive ranks, at most max_concurrent_trials
of them (`slot_plan`, JAX's rule over the host's ranks where JAX counts
the host's chips), and each slot runs its own trials. Inside the block
the functions below are relative to the rank's slot, its trial group:
`rank`, `world`, `is_primary`, `barrier`, `broadcast_object`,
`all_gather_object` and the groups "world", "data" and "model" (the slot
laid out as data x tp). The experiment has its own calls: `global_rank`,
`is_experiment_primary`, `global_barrier` and `final_wait`. Every group is
made up front, by every rank in one order: `dist.new_group` is collective
over the whole job, and the slots run out of step. A launch over more
than one host keeps one slot over the whole group, as JAX does.

Gloo reduces CPU tensors only on every build: the collectives stage a
CUDA tensor through the host under gloo.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
from typing import Any, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

logger = logging.getLogger(__name__)

COORDINATOR_ENV = ("COORDINATOR_ADDRESS", "ip_head")


@dataclasses.dataclass(frozen=True)
class Launch:
    """This process's place in the group, as its environment gives it."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    init_method: Optional[str] = None     # None: one process, no group
    source: str = "single process"


def _int(environ: Mapping[str, str], name: str, default: int) -> int:
    value = environ.get(name)
    if value in (None, ""):
        return default
    # Slurm writes per-node counts as "2(x3)"
    return int(value.split("(")[0].split(",")[0])


def _tcp(address: str, name: str) -> str:
    if ":" not in address:
        raise ValueError(f"{name}={address!r}: expected host:port")
    return f"tcp://{address}"


def launch_from_env(environ: Optional[Mapping[str, str]] = None) -> Launch:
    """Where this process stands, from torchrun's, Slurm's or the JAX
    package's variables (module docstring). Raises ValueError when a
    coordinator is named but the process count is not."""
    env = os.environ if environ is None else environ
    coord_name = next((n for n in COORDINATOR_ENV if env.get(n)), None)
    if env.get("RANK") not in (None, "") and env.get("WORLD_SIZE") not in (None, ""):
        world = _int(env, "WORLD_SIZE", 1)
        if coord_name:
            init, source = _tcp(env[coord_name], coord_name), coord_name
        else:
            if not env.get("MASTER_ADDR") or not env.get("MASTER_PORT"):
                raise ValueError("RANK and WORLD_SIZE are set but MASTER_ADDR and "
                                 "MASTER_PORT are not: name the rendezvous")
            init, source = "env://", "torchrun"
        return Launch(rank=_int(env, "RANK", 0), world=world,
                      local_rank=_int(env, "LOCAL_RANK", 0),
                      local_world=_int(env, "LOCAL_WORLD_SIZE", 1),
                      init_method=init, source=source)
    if coord_name:
        if env.get("SLURM_PROCID") in (None, "") or env.get("SLURM_NTASKS") in (None, ""):
            raise ValueError(
                f"{coord_name} is set but no process count and rank are: set "
                "WORLD_SIZE and RANK (or LOCAL_RANK and LOCAL_WORLD_SIZE with them), "
                "run under Slurm (SLURM_NTASKS, SLURM_PROCID), or unset it for one "
                "process")
        return Launch(rank=_int(env, "SLURM_PROCID", 0), world=_int(env, "SLURM_NTASKS", 1),
                      local_rank=_int(env, "SLURM_LOCALID", 0),
                      local_world=_int(env, "SLURM_NTASKS_PER_NODE", 1),
                      init_method=_tcp(env[coord_name], coord_name),
                      source=f"Slurm, {coord_name}")
    return Launch()


def _card(device: str, launch: Launch) -> str:
    """The rank's device name: cuda:<local_rank % device_count> in a group
    on cards, else `device` as given."""
    if launch.init_method is None or torch.device(device).type != "cuda":
        return device
    resolve_device("cuda")            # no card: raise before counting them
    return f"cuda:{launch.local_rank % torch.cuda.device_count()}"


def backend_for(device: torch.device, launch: Launch) -> str:
    """NCCL when each rank of a host has a card of its own; gloo on the CPU
    and when ranks share a card."""
    if device.type == "cuda" and launch.local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def active() -> bool:
    """Whether this process is in a group."""
    return dist.is_available() and dist.is_initialized()


def initialize(device: str = "cuda") -> torch.device:
    """Join the group the environment names (a no-op without one, or when
    already joined) and return this rank's device, resolved (a missing card
    raises). Logs the rank, world, backend and device."""
    launch = launch_from_env()
    if active():
        return resolve_device(local_device(device))
    dev = resolve_device(_card(device, launch))
    if launch.init_method is None:
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev, launch)
    dist.init_process_group(backend, init_method=launch.init_method,
                            rank=launch.rank, world_size=launch.world)
    logger.info("process group (%s): rank %d of %d, local rank %d of %d, backend %s, "
                "device %s", launch.source, launch.rank, launch.world, launch.local_rank,
                launch.local_world, backend, dev)
    return dev


def shutdown() -> None:
    """Leave the group, if in one (its tensor-parallel layout and trial
    groups with it)."""
    global _LAYOUT, _TRIAL
    _LAYOUT = _TRIAL = None
    if active():
        dist.destroy_process_group()


@contextlib.contextmanager
def joined(device: str = "cuda") -> Iterator[torch.device]:
    """`initialize` for the duration of the block, yielding this rank's
    device; the group is left after it when this call joined it."""
    owner = not active()
    dev = initialize(device)
    try:
        yield dev
    finally:
        if owner:
            shutdown()


def global_rank() -> int:
    """This process's rank in the whole job."""
    return dist.get_rank() if active() else 0


def global_world() -> int:
    return dist.get_world_size() if active() else 1


def is_experiment_primary() -> bool:
    """Rank 0 of the whole job: it writes an experiment's summary."""
    return global_rank() == 0


def rank() -> int:
    """This rank's place in its trial group (the job outside `trial_groups`)."""
    return global_rank() if _TRIAL is None else _TRIAL.rank


def world() -> int:
    """The ranks of this rank's trial group (the job outside `trial_groups`)."""
    return global_world() if _TRIAL is None else len(_TRIAL.ranks)


def is_primary() -> bool:
    """The leader of this rank's trial group: it writes the trial's files."""
    return rank() == 0


def local_device(device: str) -> str:
    """The device a rank trains on: `device` as given outside a group or on
    the CPU, else its card cuda:<local_rank % device_count>."""
    return _card(device, launch_from_env() if active() else Launch())


def barrier() -> None:
    """Every rank of this rank's trial group."""
    if world() > 1:
        dist.barrier(group=_group("world")[0])


def global_barrier() -> None:
    """Every rank of the job."""
    if active():
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in the data x tp layout and its two groups."""
    tp: int
    data_rank: int
    data_world: int
    model_rank: int
    data_group: Any
    model_group: Any


_LAYOUT: Optional[Layout] = None


def _check_divides(w: int, tp: int) -> None:
    if w % tp:
        raise ValueError(f"--tp {tp}: the {w} process(es) of this run do not divide "
                         f"into tensor-parallel groups of {tp} (world = data x tp)")


def _layout(ranks: Sequence[int], tp: int) -> Optional[Layout]:
    """Make the data x tp groups over `ranks` (a slot, or the job), every
    model group and then every data group; the Layout of this rank when it
    is one of them."""
    w = len(ranks)
    data = w // tp
    model_groups = [dist.new_group([ranks[i] for i in range(d * tp, (d + 1) * tp)])
                    for d in range(data)]
    data_groups = [dist.new_group([ranks[i] for i in range(m, w, tp)]) for m in range(tp)]
    if global_rank() not in ranks:
        return None
    r = list(ranks).index(global_rank())
    return Layout(tp, r // tp, data, r % tp, data_groups[r % tp], model_groups[r // tp])


def set_tensor_parallel(tp: int) -> None:
    """Split the world into data x tp (module docstring). Every rank calls
    it with the same tp: each makes every model group and every data group,
    in one order. A world that does not divide by tp raises, as JAX's
    `create_mesh` does (one process with tp > 1 included); so does a group
    that does not form. Calling it again with the same tp keeps the groups.
    Inside `trial_groups` the slot's layout was made up front: it makes no
    group, and another tp than that layout's raises."""
    global _LAYOUT
    tp = max(int(tp), 1)
    w, r = world(), rank()
    _check_divides(w, tp)
    if (_LAYOUT.tp if _LAYOUT is not None else 1) == tp:
        return
    if _TRIAL is not None:
        raise RuntimeError(f"--tp {tp} inside a trial group laid out at --tp "
                           f"{model_world()}: a trial makes no process group")
    if tp == 1:
        _LAYOUT = None
        return
    _LAYOUT = _layout(range(w), tp)
    logger.info("tensor parallel: rank %d = data %d of %d x model %d of %d", r,
                _LAYOUT.data_rank, _LAYOUT.data_world, _LAYOUT.model_rank, tp)


@dataclasses.dataclass(frozen=True)
class Trial:
    """This rank's trial group: its slot (None: the rank runs no trial),
    the slot's global ranks and the group over them."""
    slot: Optional[int]
    ranks: Tuple[int, ...]
    group: Any
    rank: int
    final_group: Any      # every rank of the job, gloo, with FINAL_WAIT


_TRIAL: Optional[Trial] = None
# How long a rank whose slot has finished waits for the others (the
# longest trial); a rank that dies closes its sockets and ends the wait.
FINAL_WAIT = datetime.timedelta(days=30)


def slot_plan(units: int, chips_per_trial: float, max_concurrent: int,
              hosts: int = 1) -> List[List[int]]:
    """JAX's trial slots (hpo/controller.py:125-140) over `units` (a host's
    chips there, its ranks here): chips_per_trial truncated to an int (0.5:
    0, all units); 0 < chips < units gives min(units // chips,
    max(max_concurrent, 1)) slots of chips consecutive units, anything else
    one slot over all units, as does more than one host."""
    chips = int(chips_per_trial) if chips_per_trial else 0
    if hosts > 1:
        chips = 0
    if chips and chips < units:
        n_slots = min(units // chips, max(max_concurrent, 1))
    else:
        n_slots, chips = 1, units
    return [list(range(s * chips, (s + 1) * chips)) for s in range(n_slots)]


def trial_slots(chips_per_trial: float, max_concurrent: int) -> List[Tuple[int, ...]]:
    """The slots of this job as global ranks: `slot_plan` over the ranks of
    this host, and a plan of one slot is every rank of the job (JAX then
    gives the trial no device subset), as when the job spans hosts (world >
    local_world); outside a group, this process."""
    if not active():
        return [(0,)]
    launch, w = launch_from_env(), global_world()
    plan = slot_plan(w, chips_per_trial, max_concurrent,
                     hosts=2 if w > launch.local_world else 1)
    return [tuple(range(w))] if len(plan) == 1 else [tuple(s) for s in plan]


@contextlib.contextmanager
def trial_groups(chips_per_trial: float, max_concurrent: int, tp: int = 1
                 ) -> Iterator[List[Tuple[int, ...]]]:
    """Within the block, this rank's trial group is its slot of
    `trial_slots` (module docstring), laid out as data x tp; yields the
    slots. Every rank makes every slot's group, then every slot's model and
    data groups, in one order, and a gloo group of the whole job to wait
    in (`final_wait`). A slot that does not divide by tp raises before any
    group is made, as does a group that does not form. One slot over the
    whole job makes no trial group: the job is the trial group, laid out by
    `set_tensor_parallel` as before."""
    global _TRIAL, _LAYOUT
    tp = max(int(tp), 1)
    slots = trial_slots(chips_per_trial, max_concurrent)
    if len(slots) == 1:
        set_tensor_parallel(tp)
        yield slots
        return
    for s in slots:
        _check_divides(len(s), tp)
    me = global_rank()
    groups = [dist.new_group(list(s)) for s in slots]
    layouts = [_layout(s, tp) if tp > 1 else None for s in slots]
    final = dist.new_group(backend="gloo", timeout=FINAL_WAIT)
    mine = next((i for i, s in enumerate(slots) if me in s), None)
    if mine is None:
        trial = Trial(None, (me,), None, 0, final)
    else:
        trial = Trial(mine, slots[mine], groups[mine], slots[mine].index(me), final)
    saved = _LAYOUT
    _TRIAL, _LAYOUT = trial, (layouts[mine] if mine is not None else None)
    logger.info("trial packing: %d slots of %d ranks, rank %d in %s", len(slots),
                len(slots[0]), me, "no slot" if mine is None else f"slot {mine}")
    try:
        yield slots
    finally:
        _TRIAL, _LAYOUT = None, saved


def trial_slot() -> Optional[int]:
    """This rank's slot inside `trial_groups` (None: no slot, it runs no
    trial); 0 outside it."""
    return 0 if _TRIAL is None else _TRIAL.slot


def final_wait() -> None:
    """Wait for every rank of the job once this rank's slot is done: inside
    `trial_groups` over its gloo group, whose timeout (FINAL_WAIT) outlasts
    the longest trial; else the job's barrier."""
    if _TRIAL is not None:
        dist.barrier(group=_TRIAL.final_group)
    else:
        global_barrier()


def data_rank() -> int:
    return rank() if _LAYOUT is None else _LAYOUT.data_rank


def data_world() -> int:
    return world() if _LAYOUT is None else _LAYOUT.data_world


def model_rank() -> int:
    return 0 if _LAYOUT is None else _LAYOUT.model_rank


def model_world() -> int:
    return 1 if _LAYOUT is None else _LAYOUT.tp


def _group(over: str) -> Tuple[Any, int]:
    """(process group, None for the job; its size) of `over`: "world" is
    this rank's trial group."""
    if over == "world":
        return (None if _TRIAL is None else _TRIAL.group), world()
    if over == "data":
        return _group("world") if _LAYOUT is None else (_LAYOUT.data_group,
                                                        _LAYOUT.data_world)
    if over == "model":
        return (None, 1) if _LAYOUT is None else (_LAYOUT.model_group, _LAYOUT.tp)
    raise ValueError(f"over={over!r}: world, data or model")


def _gloo() -> bool:
    return dist.get_backend() == "gloo"


def comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective over `t` must run: the rank's card under NCCL,
    t's own device under gloo."""
    if active() and not _gloo():
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _all_reduce_(t: torch.Tensor, op, over: str) -> torch.Tensor:
    group, size = _group(over)
    if not active() or size == 1:
        return t
    data = t.detach()
    if _gloo() and data.device.type != "cpu":
        host = data.cpu()
        dist.all_reduce(host, op=op, group=group)
        data.copy_(host)
    else:
        dist.all_reduce(data, op=op, group=group)
    return t


def all_reduce_sum_(t: torch.Tensor, over: str = "world") -> torch.Tensor:
    """Sum `t` over the ranks of `over`, in place (gloo: a CUDA tensor
    through the host); returns t. Every rank receives the same bits."""
    return _all_reduce_(t, dist.ReduceOp.SUM, over)


def all_reduce_max_(t: torch.Tensor, over: str = "world") -> torch.Tensor:
    """The elementwise max of `t` over the ranks of `over`, in place;
    returns t."""
    return _all_reduce_(t, dist.ReduceOp.MAX, over)


def all_gather(t: torch.Tensor, over: str = "model", dim: int = -1,
               host: bool = False) -> torch.Tensor:
    """Every rank's `t` of the group, in rank order, concatenated along
    `dim`: a new tensor on t's device, or with `host` in host memory (`t`
    itself over a group of one)."""
    group, size = _group(over)
    if not active() or size == 1:
        return t
    src = t.detach().contiguous()
    staged = _gloo() and src.device.type != "cpu"
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.cpu() if host else out.to(t.device)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank src's `obj` (src: a rank of the trial group) on every rank of
    the trial group (picklable objects)."""
    if world() == 1:
        return obj
    box = [obj]
    group = _group("world")[0]
    dist.broadcast_object_list(box, src=src if _TRIAL is None else _TRIAL.ranks[src],
                               group=group)
    return box[0]


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's `obj` of the trial group, in rank order."""
    if world() == 1:
        return [obj]
    out: List[Any] = [None] * world()
    dist.all_gather_object(out, obj, group=_group("world")[0])
    return out

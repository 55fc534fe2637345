"""The ``(data, model)`` device mesh and the collectives over its axes (port
of ``bert4rec_tpu/core/mesh.py``).

JAX runs one controller over a grid of devices and lets GSPMD insert the
collectives. The port runs one process per rank: ``torch.distributed``
carries a ``DeviceMesh`` of dims ``("data", "model")``, each rank holds
plain tensors (its shard of a sharded leaf, a copy of a replicated one),
and the sharded code calls the collectives below where JAX writes
``psum`` / ``pmax`` or relies on GSPMD. The encoder runs data-parallel
over ``data``; the item-embedding table and the tied softmax head are
vocab-sharded over ``model``.

Rank ``r`` sits at ``(r // mp, r % mp)``: JAX's ``devices.reshape(dp,
mp)``. The backend follows the machine: NCCL with one device a rank where
``torch.cuda.device_count() >= world``, otherwise gloo with rank ``r`` on
``cuda:(r % device_count)`` (NCCL refuses two ranks on one GPU). Only
``all_reduce`` and ``broadcast`` are used, which gloo runs on CUDA tensors;
a gather is an ``all_reduce`` of zero-padded pieces.
"""

import dataclasses
import datetime
import inspect
import logging
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class MeshConfig:
    """How to lay the ranks onto (data, model) axes.

    ``model_parallelism`` ranks shard the vocab dimension; the rest are data
    parallel. The default (1) is the right call for every shipped config
    but Reddit's 335k-item vocab.
    """
    model_parallelism: int = 1
    data_parallelism: Optional[int] = None  # None = all remaining ranks

    def resolve(self, n_devices: int) -> tuple:
        mp = self.model_parallelism
        if n_devices % mp != 0:
            raise ValueError(
                f"model_parallelism={mp} does not divide device count "
                f"{n_devices}")
        dp = self.data_parallelism or n_devices // mp
        if dp * mp != n_devices:
            raise ValueError(
                f"data_parallelism={dp} * model_parallelism={mp} != device "
                f"count {n_devices}")
        return dp, mp


def choose_backend(world: int, device_type: str) -> str:
    """NCCL where every rank gets its own CUDA device, else gloo."""
    if (device_type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


def rank_device(rank: int, world: int, device_type: str) -> torch.device:
    """The device of ``rank``: the CPU, or ``cuda:(rank % count)``."""
    if device_type != "cuda":
        return torch.device(device_type)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % count)


_DEVICE = None   # this process's rank device, set by distributed_initialize


def distributed_initialize(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda", timeout_s: float = 600.0):
    """Bring up this process's rank (``torch.distributed``).

    A no-op in a single-process run: without ``coordinator_address`` and
    without the launcher's ``MASTER_ADDR`` in the environment, or when a
    process group already exists; safe to call at program start.
    ``coordinator_address`` is ``host:port`` (rank 0 listens there);
    ``num_processes`` / ``process_id`` default to ``WORLD_SIZE`` / ``RANK``.
    The backend is :func:`choose_backend`'s and is logged."""
    global _DEVICE
    if dist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        return
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    device_type = torch.device(device).type
    backend = choose_backend(world, device_type)
    dev = rank_device(rank, world, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)   # the context, before any group
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    _log.info("rank %d of %d on %s, backend %s", rank, world, dev, backend)


class Mesh:
    """This rank's view of the ``(data, model)`` mesh: the axis sizes
    (``shape``, a dict as JAX's ``mesh.shape``), its coordinates, its
    device and the ``DeviceMesh`` whose sub-groups carry the collectives
    (None in a one-rank world, where every collective is the identity)."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, dp: int, mp: int, rank: int, device,
                 device_mesh=None, backend: Optional[str] = None):
        self.shape = {DATA_AXIS: dp, MODEL_AXIS: mp}
        self.rank = rank
        self.coords = {DATA_AXIS: rank // mp, MODEL_AXIS: rank % mp}
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.backend = backend

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


def as_mesh(mesh, where: str) -> Optional[Mesh]:
    """``mesh`` itself when it is a port mesh (None passes); anything else
    raises a TypeError naming it."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    raise TypeError(f"{where}: mesh must be a bert4rec_tpu_torch.core.mesh."
                    f"Mesh (core.create_mesh), got {type(mesh).__name__}: "
                    f"{mesh!r}")


def mesh_kwargs(fn, mesh) -> dict:
    """``{"mesh": mesh}`` where ``fn`` takes a ``mesh`` argument (a scorer
    without sharded params may not), else ``{}``."""
    if mesh is None or "mesh" not in inspect.signature(fn).parameters:
        return {}
    return {"mesh": mesh}


def create_mesh(mesh_config: Optional[MeshConfig] = None,
                devices: Optional[Sequence] = None, device=None) -> Mesh:
    """This rank's 2-D ``(data, model)`` mesh over the world's ranks (a
    one-rank world without ``torch.distributed``). ``devices`` (JAX's
    argument) lists the world's devices, one a rank in rank order: this
    rank runs on its entry, and a list whose length is not the world size
    raises. Otherwise ``device`` (this rank's own) defaults to the rank's
    device from :func:`distributed_initialize`, else ``cuda``."""
    from bert4rec_tpu_torch.core.device import resolve_device
    mesh_config = mesh_config or MeshConfig()
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if devices is not None:
        devices = list(devices)
        if device is not None:
            raise ValueError("create_mesh takes devices (the world's) or "
                             "device (this rank's), not both")
        if len(devices) != world:
            raise ValueError(f"devices lists {len(devices)} devices for a "
                             f"world of {world} ranks: one a rank, in rank "
                             f"order")
        device = devices[rank]
    dp, mp = mesh_config.resolve(world)
    dev = resolve_device(device if device is not None
                         else (_DEVICE if _DEVICE is not None else "cuda"))
    if world == 1:
        return Mesh(dp, mp, rank, dev)
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.arange(world, dtype=torch.int).reshape(dp, mp)
    device_mesh = DeviceMesh(dev.type, grid,
                             mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(dp, mp, rank, dev, device_mesh, dist.get_backend())


def batch_sharding(mesh: Mesh, ndim: int = 2) -> tuple:
    """Placements of a batch leaf over ``(data, model)``: its leading dim
    split over 'data', replicated over 'model'."""
    from torch.distributed.tensor import Replicate, Shard
    del ndim   # every batch leaf splits its dim 0, whatever its rank
    return (Shard(0), Replicate())


def replicated_sharding(mesh: Mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


# --------------------------------------------------------------------------- #
# collectives (all_reduce and broadcast only: gloo runs both on CUDA tensors)
# --------------------------------------------------------------------------- #

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(mesh: Mesh, t: torch.Tensor, axis: str,
               op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``axis`` in place (and returned); the identity on
    an axis of one rank."""
    if mesh.size(axis) > 1:
        dist.all_reduce(t, op=_OPS[op], group=mesh.group(axis))
    return t


def gather(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` along ``axis``, in axis order,
    on every rank of the axis."""
    n = mesh.size(axis)
    out = torch.zeros((n, *t.shape), dtype=t.dtype, device=t.device)
    out[mesh.index(axis)] = t
    return all_reduce(mesh, out, axis)


def broadcast_world(t: torch.Tensor) -> torch.Tensor:
    """World rank 0's ``t`` on every rank (in place)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.broadcast(t, src=0)
    return t


def barrier(mesh: Mesh) -> None:
    if mesh.device_mesh is not None:
        broadcast_world(torch.zeros(1, device=mesh.device))


class _Psum(torch.autograd.Function):
    """Forward: the sum over an axis. Backward: the identity, because the
    sum is replicated over the axis and so is its cotangent: each rank's
    gradient is that of its own term."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(mesh, x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``axis`` (``lax.psum`` under
    ``shard_map`` with a replicated result)."""
    if mesh.size(axis) == 1:
        return x
    return _Psum.apply(x, mesh, axis)


class _GatherRows(torch.autograd.Function):
    """Forward: the rows of every rank along an axis, stacked in axis order.
    Backward: this rank's rows of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return gather(mesh, x, axis).reshape(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axis)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None, None


def gather_rows(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Differentiable all-gather of a dim-0 shard over ``axis`` (what GSPMD
    does to a sharded operand that a replicated computation reads)."""
    if mesh.size(axis) == 1:
        return x
    return _GatherRows.apply(x, mesh, axis)

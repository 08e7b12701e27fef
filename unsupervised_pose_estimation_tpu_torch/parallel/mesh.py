"""The device mesh as torch.distributed process groups.

Port of ``unsupervised_pose_estimation_tpu/parallel/mesh.py``: the 3-axis
mesh ("dcn", "data", "fsdp") over the processes of a run, one device per
process. Rank r sits at ``np.unravel_index(r, (dcn, data, fsdp))``, so an
fsdp group is ``fsdp`` consecutive ranks and "dcn", the axis between
nodes, is the outermost.

- The global batch is sharded over every rank (dcn x data, and fsdp when
  it is above 1, as the reference's ``batch_axes``): rank r holds the
  contiguous rows ``[r B / n, (r + 1) B / n)`` (``batch_slices``; with
  gradient accumulation its share of each microbatch).
- Gradients are averaged over all ranks (``average_gradients``: one flat
  all-reduce), so the step computes what the one-device step computes on
  the global batch; BatchNorm takes its statistics over the global batch
  (``models.layers.BatchNorm2d.stats_group``, set by
  ``share_batch_statistics``).
- With fsdp above 1 each rank of an fsdp group keeps 1/fsdp of the main
  parameters and of their Adam moments between steps
  (``train.state.ShardedParams``); BatchNorm statistics, the GAN prior's
  networks and the step counter are replicated.

The collectives here run on any backend: under gloo a CUDA tensor goes
through a host copy (gloo has no reduce-scatter, and its CUDA support
varies), under NCCL it stays on the card. ``all_reduce_sum`` is
differentiable: its backward sums the gradients over the ranks, which is
what a statistic of the global batch needs. The ``tracing`` counters
``mesh.all_reduce`` and ``mesh.all_gather`` count the calls of each kind
(``collectives()``, the step's collective count).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing


def collectives() -> int:
    """Collectives this process has issued (the ``tracing`` counters
    ``mesh.*``)."""
    return sum(n for name, n in tracing.counters().items()
               if name.startswith("mesh."))


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a (dcn, data, fsdp) mesh of ``size``
    processes. ``group`` is the process group of all of them (None for a
    mesh of one process without a group), ``fsdp_group`` that of this
    rank's fsdp peers (None unless fsdp > 1)."""

    dcn: int
    data: int
    fsdp: int
    rank: int = 0
    group: Any = None
    fsdp_group: Any = None

    @property
    def size(self) -> int:
        return self.dcn * self.data * self.fsdp

    @property
    def coords(self) -> tuple:
        """(dcn, data, fsdp) of this rank."""
        return tuple(int(i) for i in np.unravel_index(
            self.rank, (self.dcn, self.data, self.fsdp)))

    @property
    def fsdp_index(self) -> int:
        return self.coords[2]

    def batch_slices(self, global_batch: int, accum: int = 1) -> List[slice]:
        """The rows of a global batch that this rank holds, one slice per
        microbatch: under ``accum`` microbatches of B / accum rows each,
        its 1/size of each, so that its local microbatch i is its share of
        the global microbatch i."""
        if global_batch % (self.size * accum):
            raise ValueError(f"a batch of {global_batch} does not split "
                             f"over {self.size} processes x {accum} "
                             f"microbatches")
        micro = global_batch // accum
        per = micro // self.size
        return [slice(i * micro + self.rank * per,
                      i * micro + (self.rank + 1) * per)
                for i in range(accum)]

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the mesh in place (no-op without a
        group)."""
        if self.group is not None:
            all_reduce_(tensor, self.group)
        return tensor

    def barrier(self, device):
        """Wait until every rank has come here (an all-reduce on
        ``device``, which every backend supports)."""
        if self.group is not None:
            all_reduce_(torch.zeros(1, device=device), self.group)


def make_mesh(data: int = -1, fsdp: int = 1, dcn: int = 1,
              world: Optional[int] = None, rank: Optional[int] = None,
              local_world: Optional[int] = None) -> Mesh:
    """The mesh of this process over the default process group (one
    process and no group when none is initialised; ``world`` and ``rank``
    override both, for a layout without groups).

    ``data=-1`` takes what the world leaves: ``world // (fsdp * dcn)``.
    A mesh larger than the world raises the reference's ``ValueError``, and
    so does one smaller (the processes outside it would have nothing to
    do). ``dcn`` is the axis between nodes: with dcn > 1 it must equal the
    number of nodes, ``world / LOCAL_WORLD_SIZE`` (``local_world``
    overrides the environment); otherwise the gradient all-reduce would
    cross nodes on an inner axis, which raises under NCCL (the reference's
    error on real TPUs) and warns under any other backend (its warning on
    virtual devices)."""
    have_group = world is None and initialized()
    if world is None:
        world = dist.get_world_size() if have_group else 1
    if rank is None:
        rank = dist.get_rank() if have_group else 0
    if data == -1:
        data = max(1, world // (fsdp * dcn))
    if min(data, fsdp, dcn) < 1:
        raise ValueError(f"mesh {dcn}x{data}x{fsdp}: every axis must be "
                         f"at least 1")
    n = dcn * data * fsdp
    if n > world:
        raise ValueError(f"mesh {dcn}x{data}x{fsdp} needs more than {world} "
                         f"devices")
    if n < world:
        raise ValueError(f"mesh {dcn}x{data}x{fsdp} uses {n} of the {world} "
                         f"processes; launch {n}, or size the mesh to the "
                         f"run")
    if dcn > 1:
        local = local_world or int(os.environ.get("LOCAL_WORLD_SIZE", world))
        nodes = world // max(1, local)
        if nodes != dcn:
            msg = (f"make_mesh: dcn={dcn} but the {world} processes run on "
                   f"{nodes} node(s) of {local}; the outer 'dcn' axis does "
                   f"not follow the nodes, so gradient all-reduces would "
                   f"cross nodes on an inner axis. Run with dcn equal to the "
                   f"number of nodes (or 1).")
            if have_group and dist.get_backend() == "nccl":
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=2)
    group = fsdp_group = None
    if have_group:
        group = dist.group.WORLD
        if fsdp > 1:
            # every rank creates every group, in the same order
            for start in range(0, world, fsdp):
                g = dist.new_group(list(range(start, start + fsdp)))
                if start <= rank < start + fsdp:
                    fsdp_group = g
    return Mesh(dcn=dcn, data=data, fsdp=fsdp, rank=rank, group=group,
                fsdp_group=fsdp_group)


def rank_device(device="cuda") -> torch.device:
    """``device`` for this process: a CUDA device without an index is
    ``cuda:LOCAL_RANK`` when a process group is initialised."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _staged(tensor: torch.Tensor, group) -> bool:
    """Whether ``tensor`` goes through the host for ``group``."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum a contiguous ``tensor`` over ``group`` in place."""
    tracing.count("mesh.all_reduce")
    if _staged(tensor, group):
        host = tensor.cpu()
        dist.all_reduce(host, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, group=group)
    return tensor


def all_gather_into(outs: List[torch.Tensor], tensor: torch.Tensor, group):
    """Rank i's ``tensor`` into ``outs[i]``, on every rank of ``group``."""
    tracing.count("mesh.all_gather")
    tensor = tensor.contiguous()
    if _staged(tensor, group):
        host = [torch.empty(o.shape, dtype=o.dtype) for o in outs]
        dist.all_gather(host, tensor.cpu(), group=group)
        for o, h in zip(outs, host):
            o.copy_(h)
    else:
        dist.all_gather(outs, tensor, group=group)


def all_gather(tensor: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``tensor`` (same shape on each), in rank order."""
    outs = [torch.empty_like(tensor)
            for _ in range(dist.get_world_size(group))]
    all_gather_into(outs, tensor, group)
    return outs


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return all_reduce_(tensor.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``tensor`` over ``group``, on every rank, as a new
    tensor. Differentiable: the gradient of each rank's input is the sum of
    every rank's gradient of the output, so a loss that each rank computes
    from a global statistic gets the gradient of the global loss once the
    parameters' gradients are averaged (``average_gradients``)."""
    return _AllReduceSum.apply(tensor, group)


def share_batch_statistics(module: torch.nn.Module, group):
    """Point every BatchNorm of ``module`` at ``group``, whose ranks then
    take its training statistics over all their rows (``group`` None: over
    the local batch, as on one device)."""
    for m in module.modules():
        if hasattr(m, "stats_group"):
            m.stats_group = group


def average_gradients(params: Iterable[torch.nn.Parameter], mesh: Mesh,
                      numel: Optional[int] = None,
                      zeros_for_missing: bool = False
                      ) -> Optional[torch.Tensor]:
    """Replace each parameter's gradient by its mean over the mesh: one
    all-reduce of the gradients laid end to end, divided by the mesh size,
    each parameter's ``.grad`` then a view of it; -> that flat vector,
    zero-padded to ``numel`` (None without a group). Parameters without a
    gradient are left out (every rank runs the same graph), or count as
    zeros with ``zeros_for_missing``."""
    if mesh.group is None:
        return None
    params = [p for p in params
              if zeros_for_missing or p.grad is not None]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    total = sum(g.numel() for g in grads)
    flat = torch.zeros(max(total, numel or 0), dtype=grads[0].dtype,
                       device=grads[0].device)
    torch.cat([g.reshape(-1) for g in grads], out=flat[:total])
    mesh.all_reduce_(flat)
    flat.div_(mesh.size)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat


def mean_over_ranks(values: dict, mesh: Mesh) -> dict:
    """{name: scalar tensor} -> the same names, each the mean of its values
    over the mesh (one all-reduce; the values as they are without a
    group)."""
    if mesh.group is None or not values:
        return values
    keys = sorted(values)
    stacked = torch.stack([values[k].detach().float().reshape(())
                           for k in keys])
    mesh.all_reduce_(stacked)
    stacked.div_(mesh.size)
    return dict(zip(keys, stacked.unbind()))

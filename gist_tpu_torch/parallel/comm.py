"""Collectives of the multi-rank paths on ``torch.distributed``, each
with the gradient the JAX package's ``shard_map`` collective has.

Every rank runs the same program (SPMD).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``"subnet"``, ``"graph"``); a rank's position on a dim is
``mesh.get_local_rank(name)`` (``lax.axis_index``) and the dim's
process group ``mesh.get_group(name)``.

=================================  ====================================
JAX (inside ``shard_map``)         here
=================================  ====================================
``lax.all_gather(x, axis)``        :func:`all_gather_stack`
``lax.psum`` of a value            :func:`all_reduce_sum` (its backward
                                   sums the cotangents: the value is
                                   used on every rank)
``lax.ppermute`` ring shifts       :class:`Ring` (one send and one
                                   receive per kept shift), inside the
                                   autograd functions of
                                   :mod:`gist_tpu_torch.parallel.graph_shard`
=================================  ====================================

JAX's all_to_all reference variants of the sharded aggregation have no
counterpart: the port aggregates through the ring alone.

The backend is the caller's choice (:func:`default_backend` gives
``nccl`` for a card and ``gloo`` for the CPU); nothing here switches
backend or device on an error.  gloo carries CUDA tensors for only some
collectives, so with gloo every payload of a CUDA tensor goes through
host memory: copied to the host before the collective and back after
it (:func:`_to_wire`), the same for every collective.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """The rank's device for a run on ``device``: the CPU, or the card
    ``LOCAL_RANK % device_count`` made current (every rank on the one
    card of a one-card host).  Raises for CUDA without a card."""
    from gist_tpu_torch.utils import resolve_device
    d = resolve_device(device)
    if d.type != "cuda":
        return d
    if d.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   if dist.is_initialized() else 0))
        d = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(d)
    torch.cuda.init()
    return d


def make_mesh(device, shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` over every rank of the initialised
    default process group (row-major: rank = index on the first dim
    times the second dim's size + index on the second), named
    ``names``.  The rank's device is set first, so the mesh never
    picks one from ``LOCAL_RANK`` (which names no card when several
    ranks share one)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed first "
                           "(gist_tpu_torch.multihost.init_multihost)")
    need = 1
    for s in shape:
        need *= s
    if dist.get_world_size() != need:
        raise ValueError(f"a {tuple(shape)} mesh needs {need} ranks, the "
                         f"process group has {dist.get_world_size()}")
    d = rank_device(device)
    return init_device_mesh(d.type, tuple(shape), mesh_dim_names=tuple(names))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_wire(group, t: torch.Tensor) -> torch.Tensor:
    """The payload the backend carries: a host copy of a CUDA tensor
    under gloo, else ``t`` itself (contiguous)."""
    return t.detach().cpu() if _staged(group, t) else t.contiguous()


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``t`` over ``group`` (no gradient)."""
    wire = _to_wire(group, t)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    if wire is not t:
        t.copy_(wire)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum`` of a value every rank goes on to use: the sum over
    ``group``, whose gradient is the sum of the ranks' cotangents.  A
    loss that every rank holds whole must not go through it (each rank's
    backward would count it once more); sum the ranks' local parts
    instead (:func:`gist_tpu_torch.parallel.train.masked_loss`)."""
    return _AllReduceSum.apply(t, group)


def all_gather_stack(t: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_gather``: every rank's ``t`` stacked on a new leading
    axis in group-rank order (no gradient)."""
    n = dist.get_world_size(group)
    wire = _to_wire(group, t).reshape(-1)
    out = wire.new_empty((n * wire.numel(),))
    dist.all_gather_into_tensor(out, wire, group=group)
    return out.reshape((n,) + tuple(t.shape)).to(t.device)


def all_gather_tree(tree: dict, group=None) -> dict:
    """A parameter tree ``{"layers": [{name: tensor}]}`` gathered leaf by
    leaf (:func:`all_gather_stack`): the stacked shards of the IST
    merge, in one collective."""
    leaves = [v for layer in tree["layers"] for v in layer.values()]
    flat = torch.cat([v.detach().reshape(-1) for v in leaves])
    stacked = all_gather_stack(flat, group)
    out, at = [], 0
    for layer in tree["layers"]:
        new = {}
        for k, v in layer.items():
            new[k] = stacked[:, at:at + v.numel()].reshape(
                (stacked.shape[0],) + tuple(v.shape))
            at += v.numel()
        out.append(new)
    return {"layers": out}


def all_reduce_grads_(tensors: List[torch.Tensor], group=None) -> None:
    """Sum the ``.grad`` of every tensor over ``group`` in one
    collective (the ``lax.psum`` of the sharded steps' gradients)."""
    grads = [t.grad for t in tensors]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_sum_(flat, group)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of global rank ``src`` on every rank of ``group``."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _global(group, local: int) -> int:
    return dist.get_global_rank(group, local) if group is not None \
        else local


class Ring:
    """The sends and receives of one ring exchange, posted together:
    for each kept shift k, this rank sends ``blocks[i]`` to the rank k
    places on (k places back with ``reverse``) and receives the block of
    the same shape from the rank k places back (on).  :meth:`wait`
    returns the received blocks in shift order on ``device``."""

    def __init__(self, blocks: List[torch.Tensor], shifts: Sequence[int],
                 group, reverse: bool = False):
        self.device = blocks[0].device if blocks else None
        n = dist.get_world_size(group)
        me = dist.get_rank(group)
        sign = -1 if reverse else 1
        ops, self.recv = [], []
        for k, blk in zip(shifts, blocks):
            send = _to_wire(group, blk)
            recv = torch.empty_like(send)
            ops.append(dist.P2POp(dist.isend, send,
                                  _global(group, (me + sign * k) % n), group))
            ops.append(dist.P2POp(dist.irecv, recv,
                                  _global(group, (me - sign * k) % n), group))
            self.recv.append(recv)
        self.reqs = dist.batch_isend_irecv(ops) if ops else []

    def wait(self) -> List[torch.Tensor]:
        for r in self.reqs:
            r.wait()
        return [r.to(self.device) for r in self.recv]

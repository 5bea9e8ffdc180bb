"""The data mesh: which envs a rank holds, and the collectives over ranks.

Port of quadswarm_tpu/parallel/mesh.py.  The JAX package shards the env
batch over a 1-D `data` mesh axis and lets XLA insert the gradient psum;
the port runs one process per card (`parallel/distributed.py`), so a mesh
is a process group: rank r of a world of D holds envs
[r E / D, (r + 1) E / D), the JAX package's `P("data")` layout, and the
trainers call the collectives below themselves.  They take an explicit
all-reduce rather than DDP's module wrapper: mixed-policy PBT
differentiates stacked weights through `torch.func`, which the wrapper
does not fit.

A mesh without a process group (or no mesh, None) is a world of one, and
every collective on it returns its input untouched: the one-card port runs
the same code as a world of D ranks.  A world of one with a group (a
1-rank NCCL world) runs the collectives, whose sums over one rank change
no bit.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from quadswarm_tpu_torch.utils.struct import map_fields


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """`world` ranks of a process `group` (None: a world of one without a
    group); this process is `rank` of them, on `device`.  `ranks` are the
    members' ranks in the job, in mesh order (a subgroup's differ)."""

    world: int
    rank: int
    device: torch.device
    group: object = None
    ranks: tuple = (0,)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(group=None, device="cuda") -> DataMesh:
    """The mesh of `group` (the job's whole world by default), or a world
    of one without a group when no process group exists.  On CUDA the
    device is the rank's current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return DataMesh(1, 0, device)
    group = group if group is not None else dist.group.WORLD
    ranks = tuple(dist.get_process_group_ranks(group))
    return DataMesh(len(ranks), ranks.index(dist.get_rank()), device, group,
                    ranks)


def local_mesh(device="cuda") -> DataMesh:
    """A world of one without a group, whatever process group exists."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return DataMesh(1, 0, device)


def split_mesh(mesh: DataMesh, sizes: tuple) -> list:
    """Cut a mesh into consecutive subgroups of `sizes` ranks (every rank
    of the mesh must call this, in the same order).  Returns one entry a
    part: its mesh where this rank belongs to it, else None."""
    if sum(sizes) != mesh.world:
        raise ValueError(f"parts {sizes} do not cover a world of "
                         f"{mesh.world}")
    out, start = [], 0
    for size in sizes:
        members = mesh.ranks[start:start + size]
        group = dist.new_group(list(members))
        me = mesh.ranks[mesh.rank]
        out.append(DataMesh(size, members.index(me), mesh.device, group,
                            tuple(members)) if me in members else None)
        start += size
    return out


def env_range(mesh: DataMesh, num_envs: int) -> tuple[int, int]:
    """The contiguous env range [lo, hi) of this rank."""
    if num_envs % mesh.world:
        raise ValueError(f"{num_envs} envs do not split evenly over "
                         f"{mesh.world} ranks")
    share = num_envs // mesh.world
    return mesh.rank * share, (mesh.rank + 1) * share


def shard_env_batch(mesh: DataMesh, tree, axis: int = 0):
    """This rank's envs of a global batch: every leaf of a tensor, a
    tuple or a dataclass of them sliced along its env axis `axis`."""
    def cut(x):
        lo, hi = env_range(mesh, x.shape[axis])
        return x.narrow(axis, lo, hi - lo)
    if isinstance(tree, tuple):
        return type(tree)(*(shard_env_batch(mesh, x, axis) for x in tree))
    return map_fields(lambda x: None if x is None else cut(x), tree)


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------

def _alone(mesh: DataMesh | None) -> bool:
    return mesh is None or mesh.group is None


def world_size(mesh: DataMesh | None) -> int:
    return 1 if mesh is None else mesh.world


def all_sum(mesh: DataMesh | None, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the mesh, as a new tensor (`x` itself without a
    group)."""
    if _alone(mesh):
        return x
    x = x.clone()
    dist.all_reduce(x, group=mesh.group)
    return x


def all_mean(mesh: DataMesh | None, x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the mesh's ranks."""
    return all_sum(mesh, x) / world_size(mesh)


def all_sum_dict(mesh: DataMesh | None, tensors: dict) -> dict:
    """Every float tensor of a dict summed over the mesh in one
    all-reduce."""
    if _alone(mesh):
        return tensors
    keys = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1).to(torch.float32)
                      for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    out, start = {}, 0
    for k in keys:
        t = tensors[k]
        out[k] = flat[start:start + t.numel()].reshape(t.shape)
        start += t.numel()
    return out


def all_reduce_grads_(mesh: DataMesh | None, grads: list,
                      average: bool = True) -> None:
    """Sum (or average) gradients over the mesh in place, as ONE flat
    bucket: one all-reduce a step rather than one a parameter tensor (the
    JAX package flattens too, `optax.flatten`)."""
    if _alone(mesh):
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    if average:
        flat.div_(mesh.world)
    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(f.view_as(g))


def broadcast_(mesh: DataMesh, tensors: list, src: int = 0) -> None:
    """Overwrite `tensors` on every rank with mesh rank `src`'s, one
    broadcast a dtype."""
    if _alone(mesh) or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=mesh.ranks[src], group=mesh.group)
        for t, f in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(f.view_as(t))


def replicate(mesh: DataMesh, module_or_tensors, src: int = 0) -> None:
    """Give every rank mesh rank `src`'s weights: a module's parameters and
    buffers, or a list of tensors, in place."""
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = (list(module_or_tensors.parameters())
                   + list(module_or_tensors.buffers()))
    else:
        tensors = list(module_or_tensors)
    with torch.no_grad():
        broadcast_(mesh, tensors, src)


def _staged(mesh: DataMesh, x: torch.Tensor) -> bool:
    """Gloo sends no CUDA tensor: point-to-point transfers of one stage
    through host memory."""
    return x.is_cuda and dist.get_backend(mesh.group) == "gloo"


def exchange(mesh: DataMesh, sends: list, recvs: list) -> None:
    """Point-to-point transfers between mesh ranks: `sends` are (tensor,
    dst) pairs, `recvs` (buffer, src) pairs filled in place.  All are
    posted at once and then awaited.  Over gloo a CUDA tensor goes through
    a pinned host buffer: copied there (and synchronised) before its send,
    copied back after its receive."""
    ops, unstage = [], []
    for x, dst in sends:
        x = (x.to("cpu").pin_memory() if _staged(mesh, x)
             else x.contiguous())
        ops.append(dist.P2POp(dist.isend, x, mesh.ranks[dst], mesh.group))
    for buf, src in recvs:
        target = buf
        if _staged(mesh, buf):
            target = torch.empty(buf.shape, dtype=buf.dtype,
                                 pin_memory=True)
            unstage.append((buf, target))
        ops.append(dist.P2POp(dist.irecv, target, mesh.ranks[src],
                              mesh.group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    for buf, host in unstage:
        buf.copy_(host)

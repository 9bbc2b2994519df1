"""Point-sharded MSM over a torch.distributed device mesh.

Counterpart of `kogarashi_tpu/parallel/msm.py`: `make_mesh` (:29) and
`distributed_msm_pallas` (:80). The points and scalars are split over one
mesh axis; each rank runs the port's Pippenger (`ops/msm.py::msm`, on K1-K4)
over its n/D points, then one all_gather of a single projective point per
rank and a (D - 1)-add fold with K3 at one lane (:128-134). Collective
traffic is D points, whatever n is.

Each rank runs the MSM's ordinary window loop. The JAX function passes
`scan_windows=True` (:125) only because `shard_map` traces its body, and a
traced Python loop would unroll; nothing here is traced.

Not ported: the JAX package's `distributed_msm` (:36), which shards its
older all-XLA MSM (`kogarashi_tpu/ops/msm.py`, replaced there by
`msm_pallas`); `distributed_msm` here is the counterpart of
`distributed_msm_pallas`.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..curves import Curve
from ..ops import ec
from ..ops.msm import msm
from .launch import rank_device


def make_mesh(shape=None, names=("shard",)) -> DeviceMesh:
    """A DeviceMesh over the initialised default process group: 1-D over
    every rank by default, or `shape` (its product the world size) with one
    name per axis. Its device type is the ranks' (`launch.rank_device`)."""
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(shape)
    names = tuple(names)
    if len(shape) != len(names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} with axes {names} does not cover {world} ranks")
    return DeviceMesh(rank_device().type, torch.arange(world).reshape(shape), mesh_dim_names=names)


def mesh_axis(mesh: DeviceMesh, axis: str):
    """(process group, size D, this rank's index) of one mesh axis."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r} (axes {mesh.mesh_dim_names})")
    return mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh, device=None) -> torch.device:
    """The rank's device on `mesh`; an explicit `device` must be of the
    mesh's type (a CUDA mesh runs on the current card)."""
    if device is None:
        return rank_device() if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"device {device} on a {mesh.device_type} mesh")
    return device


def all_gather_stack(t: torch.Tensor, group, nd: int) -> torch.Tensor:
    """(...) on each of the group's nd ranks -> (nd, ...), in rank order."""
    parts = [torch.empty_like(t) for _ in range(nd)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def distributed_msm(curve: Curve, x, y, inf, scalars, c: int | None = None,
                    mesh: DeviceMesh | None = None, axis: str = "shard"):
    """sum_i scalars[i] * P_i with the n points split over `axis` of `mesh`
    (default: every rank on one axis). Counterpart of the JAX package's
    `distributed_msm_pallas`.

    x, y: (rows, n) affine Montgomery words, inf: (n,) bool, scalars: (16, n)
    standard-form 16-bit limbs, as `ops/msm.py::msm` takes them: the whole
    input, on the rank's device; rank i of the axis takes points
    [i n/D, (i + 1) n/D). Returns the sum, three (rows, 1) word tensors, on
    every rank. Raises ValueError when D does not divide n."""
    mesh = make_mesh() if mesh is None else mesh
    group, nd, idx = mesh_axis(mesh, axis)
    if x.device.type != mesh.device_type:
        raise ValueError(f"points on {x.device}, mesh on {mesh.device_type}")
    n = x.shape[-1]
    if n % nd:
        raise ValueError(f"n={n} points not divisible by mesh axis {axis!r} of size {nd}")
    sl = slice(idx * (n // nd), (idx + 1) * (n // nd))
    part = msm(curve, x[:, sl].contiguous(), y[:, sl].contiguous(), inf[sl].contiguous(),
               scalars[:, sl].contiguous(), c=c)
    every = all_gather_stack(torch.stack(part), group, nd)  # (D, 3, rows, 1)
    acc = tuple(every[0, i].contiguous() for i in range(3))
    for d in range(1, nd):
        acc = ec.map_padd(curve, acc, tuple(every[d, i].contiguous() for i in range(3)))
    return acc

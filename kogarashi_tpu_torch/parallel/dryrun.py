"""One distributed proving step on `n_ranks` ranks, every result checked.

Counterpart of `__graft_entry__.py::dryrun_multichip` (:40): the H-polynomial
pipeline (`distributed_h_coeffs`, each transform a 4-step NTT with one
all-to-all) held to the single-device `Domain` pipeline, then the
point-sharded G1 MSM (`distributed_msm`, on K1-K4 in every rank) held to the
host oracle, and repeated on a 2-D (dp, shard) mesh when the rank count is
even and at least 4. The rank functions below (`rank_ntt`, `rank_h_coeffs`,
`rank_msm`) run single pieces of it under `launch`; the tests use them.
"""

from __future__ import annotations

import random
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from ..bench import oracle
from ..curves import CURVES, G1, decode_points, prepare_points
from ..fields import mont
from ..fields.spec import FR
from ..ops import ec
from ..ops.msm import default_window, msm
from ..ops.ntt import Domain
from .launch import BACKENDS, launch, rank_device
from .msm import all_gather_stack, distributed_msm, make_mesh
from .ntt import DistributedDomain
from .prover import distributed_h_coeffs

N_BASES = 16  # distinct MSM bases, tiled (`__graft_entry__.py:107`)
SEED = 3  # the inputs' seed (`__graft_entry__.py:74`)
REPS = 3  # warm timed calls of each pipeline and its single-device counterpart


def h_inputs(log_n: int, device):
    """A satisfied system's evaluations: az, bz random below p (as Montgomery
    words), cz = az * bz, each (8, 2^log_n) on `device`."""
    raw = np.random.default_rng(SEED).integers(0, 1 << 32, size=(2, 8, 1 << log_n), dtype=np.uint64)
    raw[:, 7] &= 0x1FFFFFFF  # < 2^253 < p
    az, bz = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(device).unbind(0)
    return az, bz, mont.mul(az, bz, spec=FR)


def single_h_coeffs(dom: Domain, az, bz, cz):
    """The single-device H pipeline, as `groth16/prover.py` runs it."""
    on_coset = dom.coset_dft(dom.idft(torch.stack([az, bz, cz], dim=1)))
    h = mont.sub(mont.mul(on_coset[:, 0], on_coset[:, 1], spec=FR), on_coset[:, 2], spec=FR)
    return dom.coset_idft(dom.divide_by_z_on_coset(h))


def msm_inputs(log_n: int, device):
    """N_BASES G1 bases from random.Random(SEED), tiled to 2^log_n points
    (point i is base i mod N_BASES), and scalars below 2^254 from numpy's
    generator on SEED: (x, y, inf, scalars, bases' discrete logs, the
    scalars as a (16, n) numpy array)."""
    rng = random.Random(SEED)
    g = G1.pyref_spec.generator
    dk = [rng.randrange(1, FR.p) for _ in range(N_BASES)]
    x16, y16, inf16 = prepare_points(G1, [k * g for k in dk], device)
    reps = (1 << log_n) // N_BASES
    sc = np.random.default_rng(SEED).integers(0, 1 << 16, size=(16, 1 << log_n), dtype=np.uint32)
    sc[15] &= 0x3FFF
    scalars = torch.from_numpy(sc.astype(np.int32)).to(device)
    return x16.repeat(1, reps), y16.repeat(1, reps), inf16.repeat(reps), scalars, dk, sc


def _rank_dryrun(log_h: int, log_msm: int):
    dev = rank_device()
    world = dist.get_world_size()

    def clock(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    mesh = make_mesh()
    two_d = world >= 4 and world % 2 == 0
    n, n2 = 1 << log_msm, 32 * world  # n2: the 2-D mesh's points (`__graft_entry__.py:139`)
    if n % N_BASES or (two_d and n2 > n):
        raise ValueError(f"2^{log_msm} points: need a multiple of {N_BASES}" + (f" and at least {n2}" if two_d else ""))
    mesh2 = make_mesh((2, world // 2), ("dp", "shard")) if two_d else None
    az, bz, cz = h_inputs(log_h, dev)
    x, y, inf, sc, dk, sc_np = msm_inputs(log_msm, dev)

    dd, t_tables = clock(lambda: DistributedDomain(log_h, mesh, device=dev))
    t_tables_warm = clock(lambda: DistributedDomain(log_h, mesh, device=dev))[1]  # the first pays CUDA's warm-up
    ec.reset_launches()  # counts from here on are the distributed path's
    h, t_h = clock(lambda: distributed_h_coeffs(dd, az, bz, cz))
    pt, t_msm = clock(lambda: distributed_msm(G1, x, y, inf, sc, mesh=mesh))
    if two_d:
        pt2 = distributed_msm(G1, x[:, :n2], y[:, :n2], inf[:n2], sc[:, :n2], mesh=mesh2)
    launches = dict(ec.LAUNCHES)
    by_group = {k: dict(sorted(v.items())) for k, v in ec.GROUP_LAUNCHES.items()}

    dom = Domain(log_h, device=dev)
    if not torch.equal(h, single_h_coeffs(dom, az, bz, cz)):
        raise AssertionError(f"distributed H pipeline at 2^{log_h} differs from the single-device pipeline")
    if decode_points(G1, pt)[0] != oracle(G1, dk, sc_np[:, :n]):
        raise AssertionError(f"distributed G1 MSM at 2^{log_msm} differs from the host oracle")
    if two_d and decode_points(G1, pt2)[0] != oracle(G1, dk, sc_np[:, :n2]):
        raise AssertionError(f"distributed G1 MSM on the 2-D mesh ({n2} points) differs from the host oracle")

    times = {"h_s": [], "h_single_s": [], "msm_s": [], "msm_single_s": []}
    for _ in range(REPS):  # warm calls, each ended by a synchronisation
        times["h_s"].append(clock(lambda: distributed_h_coeffs(dd, az, bz, cz))[1])
        times["h_single_s"].append(clock(lambda: single_h_coeffs(dom, az, bz, cz))[1])
        times["msm_s"].append(clock(lambda: distributed_msm(G1, x, y, inf, sc, mesh=mesh))[1])
        times["msm_single_s"].append(clock(lambda: msm(G1, x, y, inf, sc))[1])
    if dist.get_rank():
        return None
    return dict(
        world=world, backend=dist.get_backend(), two_d=two_d, log_h=log_h, log_msm=log_msm,
        c=default_window(n // world),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        tables_s=t_tables, tables_warm_s=t_tables_warm, h_first_s=t_h, msm_first_s=t_msm, **times,
        **{f"{k}_median": statistics.median(v) for k, v in times.items()},
        launches=launches, group_launches=by_group,
    )


def dryrun_multichip(n_ranks: int, backend: str, device_kind: str, log_h: int = 14, log_msm: int = 14) -> dict:
    """One distributed proving step on `n_ranks` ranks of `backend` ("nccl"
    on `device_kind` "cuda", one card a rank; "gloo" on "cpu"): the H
    pipeline at 2^log_h against the single-device pipeline, the G1 MSM over
    2^log_msm points (each rank's window `msm`'s default for its n/D points,
    16 at 2^20 on one rank) against the host oracle, on a 1-D mesh and,
    for an even n_ranks >= 4, a 2-D (dp, shard) one. A failed check raises
    in the rank and so here. Returns rank 0's record: the seconds of the
    table build (the first, and a second one warm), of the first (counted)
    calls and of REPS warm calls of each pipeline beside its single-device
    counterpart, and the K1-K4 launches the distributed path made inside
    rank 0 (`ops.ec.LAUNCHES`, K2's and K4's also by lane group)."""
    if BACKENDS.get(backend) != device_kind:
        raise ValueError(f"backend {backend!r} on {device_kind!r}: use nccl on cuda or gloo on cpu")
    return launch(_rank_dryrun, n_ranks, backend, args=(log_h, log_msm))


# ---------------------------------------------------------------------------
# pieces of the step, one rank function each: run them with `launch` (or
# several in one launch with `launch.run_each`); each returns numpy arrays
# ---------------------------------------------------------------------------


def rank_ntt(k: int, coeffs, evals) -> dict:
    """Every DistributedDomain transform on this rank's shards of `coeffs`
    and `evals` ((8, 2^k) words) on a 1-D mesh over every rank, gathered to
    the natural order: dft, coset_dft (of coeffs), idft, coset_idft of
    divide_by_z_on_coset (of evals), idft of dft (coeffs back); and the
    shards of dft(scatter_input(coeffs)) and idft(scatter_evals(evals)) of
    every rank, stacked in rank order, as they are before any gather."""
    dev = rank_device()
    dd = DistributedDomain(k, device=dev)
    x, e = (torch.from_numpy(np.asarray(a)).to(dev) for a in (coeffs, evals))
    ev = dd.dft(dd.scatter_input(x))
    co = dd.idft(dd.scatter_evals(e))
    out = {
        "dft": dd.gathered(ev),
        "coset_dft": dd.gathered(dd.coset_dft(dd.scatter_input(x))),
        "idft": dd.gathered_coeffs(co),
        "coset_idft_of_divide": dd.gathered_coeffs(dd.coset_idft(dd.divide_by_z_on_coset(dd.scatter_evals(e)))),
        "roundtrip": dd.gathered_coeffs(dd.idft(ev)),
        "dft_shards": all_gather_stack(ev, dd.group, dd.nd),
        "idft_shards": all_gather_stack(co, dd.group, dd.nd),
    }
    return {name: t.cpu().numpy() for name, t in out.items()}


def rank_h_coeffs(k: int, az, bz, cz):
    """`distributed_h_coeffs` on a 1-D mesh over every rank; (8, 2^k) words."""
    dev = rank_device()
    args = (torch.from_numpy(np.asarray(a)).to(dev) for a in (az, bz, cz))
    return distributed_h_coeffs(DistributedDomain(k, device=dev), *args).cpu().numpy()


def rank_msm(curve_name: str, x, y, inf, scalars, c, shape=None, names=("shard",)):
    """`distributed_msm` over the "shard" axis of `make_mesh(shape, names)`;
    the (3, rows, 1) sum."""
    dev = rank_device()
    mesh = make_mesh(shape, names)
    ts = (torch.from_numpy(np.asarray(a)).to(dev) for a in (x, y, inf, scalars))
    return torch.stack(distributed_msm(CURVES[curve_name], *ts, c=c, mesh=mesh)).cpu().numpy()

"""The port's distributed leg (`kogarashi_tpu_torch.parallel`) on gloo ranks
on the CPU, against the JAX package: the 4-step NTT family and the H
pipeline equal `kogarashi_tpu.ops.ntt.Domain`'s results exactly at 2 and 4
ranks; the shards of `dft` and `idft` equal those of the JAX package's own
`DistributedDomain` on a 4-device submesh of the virtual mesh, word for
word; the point-sharded MSM equals the pyref oracle and the port's
single-device `msm` on 1, 2 and 4 ranks and on a 2x2 mesh; and `launch`
fails a call whose rank raises, dies or passes its deadline.

The ranks are spawned processes that import only the port (their functions
live in `kogarashi_tpu_torch.parallel`); each runs on one thread, and every
launch is joined under DEADLINE_S. The launches run on a background thread
while this process computes the JAX package's results."""

import math
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessExitedException, ProcessRaisedException

from kogarashi_tpu.fields import mont as jmont
from kogarashi_tpu.fields.spec import FR as JFR
from kogarashi_tpu.ops.ntt import Domain as JDomain
from kogarashi_tpu.parallel import DistributedDomain as JDistributedDomain
from kogarashi_tpu.parallel import make_mesh as jax_make_mesh
from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch import interop
from kogarashi_tpu_torch.curves import G1, decode_points, prepare_points
from kogarashi_tpu_torch.fields.spec import FR, ints_to_limbs16
from kogarashi_tpu_torch.ops.msm import msm
from kogarashi_tpu_torch.parallel import dryrun as DR
from kogarashi_tpu_torch.parallel.launch import launch, run_each

torch.set_num_threads(2)  # the suite runs several workers side by side

K = 6  # the NTT family's and the H pipeline's domain
K_LAYOUT = 4  # the smallest domain 4 ranks allow: D^2 = 16 divides 2^4
N_MSM, C_MSM = 64, 8
DEADLINE_S = 120


def _vals(n, seed):
    raw = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [int.from_bytes(r.astype("<u4").tobytes(), "little") % FR.p for r in raw]


def _jax(vals):
    return jnp.asarray(JFR.encode(vals).T)


def _words(jarr):
    return interop.words_from_limbs16(np.asarray(jarr))


COEFFS, EVALS = _vals(1 << K, 1), _vals(1 << K, 2)
AZ, BZ = _vals(1 << K, 3), _vals(1 << K, 4)
CZ = [a * b % FR.p for a, b in zip(AZ, BZ)]  # a satisfied system: H is exact
LAYOUT = _vals(1 << K_LAYOUT, 5)


def _msm_case():
    """64 G1 points with an identity (shard 0), a zero scalar (index 17) and
    R - 1 (index 63): at 2 and 4 ranks the three sit in different shards."""
    rng = random.Random(0xD157)
    g = G1.pyref_spec.generator
    pts = [rng.randrange(1, C.R) * g for _ in range(N_MSM)]
    pts[3] = G1.pyref_spec.identity_affine()
    ks = [rng.randrange(C.R) for _ in range(N_MSM)]
    ks[17], ks[63] = 0, C.R - 1
    return pts, ks


def _rank_calls(world):
    """The rank functions one launch of `world` gloo ranks runs."""
    pts, ks = _msm_case()
    x, y, inf = (t.numpy() for t in prepare_points(G1, pts, "cpu"))
    msm_args = ("g1", x, y, inf, ints_to_limbs16(ks), C_MSM)
    calls = [(DR.rank_msm, msm_args)]
    if world > 1:
        words = [FR.encode(v) for v in (COEFFS, EVALS, AZ, BZ, CZ)]
        calls += [(DR.rank_ntt, (K, words[0], words[1])), (DR.rank_h_coeffs, (K, *words[2:]))]
    if world == 4:
        calls += [(DR.rank_msm, msm_args + ((2, 2), ("dp", "shard"))),
                  (DR.rank_ntt, (K_LAYOUT, FR.encode(LAYOUT), FR.encode(LAYOUT)))]
    return calls


@pytest.fixture(scope="module")
def ranks():
    """{world: results of `_rank_calls(world)`, "dryrun": the record of
    `dryrun_multichip` on 4 ranks}, launched on a background thread one
    after the other; each test waits for the one it reads."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        futures = {w: pool.submit(launch, run_each, w, "gloo", (_rank_calls(w),), DEADLINE_S)
                   for w in (4, 2, 1)}
        futures["dryrun"] = pool.submit(DR.dryrun_multichip, 4, "gloo", "cpu", 4, 7)
        yield {w: (lambda f=f: f.result(timeout=3 * DEADLINE_S)) for w, f in futures.items()}


@pytest.fixture(scope="module")
def jax_ref(ranks):
    """The JAX package's single-device Domain results on the same inputs.
    The five vectors go through each transform as one batch (the transforms
    act on the last axis only), so JAX dispatches each op at one shape."""
    dom = JDomain(K)
    batch = jnp.stack([_jax(v) for v in (COEFFS, EVALS, AZ, BZ, CZ)], axis=1)  # (16, 5, n)
    idft = dom.idft(batch)
    on_coset = dom.coset_dft(idft)  # the pipeline: coset_dft(idft(A, B, C))
    h = jmont.sub(jmont.mont_mul(on_coset[:, 2], on_coset[:, 3], JFR), on_coset[:, 4], JFR)
    coset_idft = dom.coset_idft(dom.divide_by_z_on_coset(batch.at[:, 0].set(h)))
    out = {
        "dft": dom.dft(batch)[:, 0],
        "coset_dft": dom.coset_dft(batch)[:, 0],
        "idft": idft[:, 1],
        "coset_idft_of_divide": coset_idft[:, 1],
        "h": coset_idft[:, 0],
    }
    return {k: _words(v) for k, v in out.items()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", ["dft", "coset_dft", "idft", "coset_idft_of_divide"])
def test_ntt_family_matches_jax(ranks, jax_ref, world, op):
    got = ranks[world]()[1]
    assert np.array_equal(got[op], jax_ref[op])
    assert np.array_equal(got["roundtrip"], FR.encode(COEFFS))


@pytest.mark.parametrize("world", [2, 4])
def test_h_coeffs_match_jax_pipeline(ranks, jax_ref, world):
    """`distributed_h_coeffs` against the JAX single-device pipeline that
    tests/test_parallel.py:78-106 builds."""
    assert np.array_equal(ranks[world]()[2], jax_ref["h"])


@pytest.mark.parametrize("op", ["dft", "idft"])
def test_shard_layout_matches_jax_distributed_domain(ranks, op):
    """Each rank's shard of dft(scatter_input(x)) and idft(scatter_evals(x)),
    before any gather, equals the same device's shard of the JAX package's
    DistributedDomain on 4 devices: an all-to-all that permutes the blocks
    wrongly gives a well-formed array that fails here."""
    dd = JDistributedDomain(K_LAYOUT, jax_make_mesh(4))
    x = _jax(LAYOUT)
    want = dd.dft(dd.scatter_input(x)) if op == "dft" else dd.idft(dd.scatter_evals(x))
    shards = sorted(want.addressable_shards, key=lambda s: s.device.id)
    got = ranks[4]()[4][f"{op}_shards"]
    assert got.shape[0] == len(shards) == 4
    for r, s in enumerate(shards):
        assert s.index[-1] == slice(r * got.shape[-1], (r + 1) * got.shape[-1])
        assert np.array_equal(got[r], _words(s.data)), f"rank {r}"


@pytest.fixture(scope="module")
def msm_want():
    pts, ks = _msm_case()
    acc = G1.pyref_spec.identity_affine()
    for p, k in zip(pts, ks):
        acc = acc + (k % C.R) * p
    x, y, inf = prepare_points(G1, pts, "cpu")
    single = msm(G1, x, y, inf, torch.from_numpy(ints_to_limbs16(ks)), c=C_MSM)
    assert decode_points(G1, single)[0] == acc
    return acc


@pytest.mark.parametrize("world,call", [(1, 0), (2, 0), (4, 0), (4, 3)], ids=["1", "2", "4", "2x2"])
def test_distributed_msm_matches_oracle(ranks, msm_want, world, call):
    """Also the port's single-device msm (`msm_want` holds it to the oracle)."""
    got = ranks[world]()[call]
    assert decode_points(G1, tuple(torch.from_numpy(c) for c in got))[0] == msm_want


def test_dryrun_multichip_on_gloo(ranks):
    """The dry run's own checks pass on 4 ranks (1-D and 2-D meshes, H at 2^4,
    the MSM over 2^7 points); the CPU runs the plain versions, which count no
    kernel launch."""
    rec = ranks["dryrun"]()
    assert (rec["world"], rec["backend"], rec["two_d"], rec["device"], rec["c"]) == (4, "gloo", True, "cpu", 8)
    assert len(rec["h_s"]) == len(rec["msm_single_s"]) == DR.REPS
    assert not any(rec["launches"].values())


@pytest.mark.parametrize("case", ["n % D", "n % D^2"])
def test_shapes_the_mesh_cannot_split_raise(case):
    if case == "n % D":
        z = np.zeros((8, 6), np.int32)
        call = (DR.rank_msm, ("g1", z, z, np.zeros(6, bool), np.zeros((16, 6), np.int32), C_MSM))
        match = "n=6 points not divisible by mesh axis 'shard' of size 4"
    else:
        z = np.zeros((8, 4), np.int32)
        call = (DR.rank_ntt, (2, z, z))
        match = r"need N = 2\^2 divisible by D\^2 = 16"
    with pytest.raises(ProcessRaisedException, match=f"ValueError: {match}"):
        launch(call[0], 4, "gloo", args=call[1], timeout_s=DEADLINE_S)


@pytest.mark.parametrize("case", ["raises", "dies", "hangs"])
def test_failed_rank_fails_the_call(case):
    """A rank that raises or dies fails the call at once; one still running
    at the deadline fails it there, and every rank is ended."""
    fn, args, timeout_s, err = {
        "raises": (math.sqrt, (-1.0,), DEADLINE_S, ProcessRaisedException),
        "dies": (os._exit, (3,), DEADLINE_S, ProcessExitedException),
        "hangs": (time.sleep, (600,), 3.0, TimeoutError),
    }[case]
    t0 = time.monotonic()
    with pytest.raises(err):
        launch(fn, 2, "gloo", args=args, timeout_s=timeout_s)
    assert time.monotonic() - t0 < 60


def test_no_backend_or_device_is_picked_for_the_caller():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs 1 CUDA devices, 0 visible"):
            launch(math.sqrt, 1, "nccl", args=(1.0,))
    with pytest.raises(ValueError, match="backend 'mpi'"):
        launch(math.sqrt, 1, "mpi", args=(1.0,))
    with pytest.raises(ValueError, match="nccl on cuda or gloo on cpu"):
        DR.dryrun_multichip(1, "nccl", "cpu")

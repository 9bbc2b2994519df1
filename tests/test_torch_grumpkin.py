"""Grumpkin (y^2 = x^3 - 17 over Fr), the commitment curve of Nova's
secondary circuit, on the port's MSM, on the CPU: its constants against the
JAX package's, an MSM against the pyref oracle with scalars near q
(Grumpkin's group order), and its lane groups at a commit's shapes. K1-K4's
parity with the JAX package and their bounds are Grumpkin's cases of the
parametrised tests in test_torch_ec.py."""

import random

import numpy as np
import pytest
import torch

from kogarashi_tpu import constants as JC
from kogarashi_tpu.pyref import GRUMPKIN_SPEC as JGRUMPKIN_SPEC
from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch.curves import GRUMPKIN, decode_points, prepare_points
from kogarashi_tpu_torch.fields.spec import ints_to_limbs16
from kogarashi_tpu_torch.ops import ec
from kogarashi_tpu_torch.ops import msm as M

torch.set_num_threads(2)  # the suite runs several workers side by side


def test_grumpkin_constants_match_jax():
    for name in ("GRUMPKIN_B", "GRUMPKIN_GEN"):
        assert getattr(C, name) == getattr(JC, name), name
    g, jg = GRUMPKIN.pyref_spec.generator, JGRUMPKIN_SPEC.generator
    assert (g.x.v, g.y.v) == (jg.x.v, jg.y.v)
    assert GRUMPKIN.b3 == JGRUMPKIN_SPEC.b3.v


@pytest.mark.parametrize("n,c", [(64, 8), (256, None)], ids=["64-c8", "256-default"])
def test_msm_vs_oracle_scalars_near_q(n, c):
    """Scalars near q (Grumpkin's group order, above r), and q - 1, 0 and
    1, with repeated bases and identities; the K2 launches are the ones
    `scan_proj_launches` works out."""
    rng = random.Random(n)
    g = GRUMPKIN.pyref_spec.generator
    base = [rng.randrange(1, C.Q) * g for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    pts[3] = pts[11] = GRUMPKIN.pyref_spec.identity_affine()
    near = np.random.default_rng(n).integers(0, 1 << 62, size=n - 3)
    ks = [C.Q - 1 - int(v) for v in near] + [C.Q - 1, 0, 1]
    assert all(C.R < k < C.Q for k in ks[:-2])
    x, y, inf = prepare_points(GRUMPKIN, pts, "cpu")
    seen = {}
    real = M.ec.scan_proj

    def spy(curve_, *xyz):
        seen[tuple(xyz[0].shape[1:])] = seen.get(tuple(xyz[0].shape[1:]), 0) + 1
        return real(curve_, *xyz)

    M.ec.scan_proj = spy
    try:
        out = M.msm(GRUMPKIN, x, y, inf, torch.from_numpy(ints_to_limbs16(ks)), c=c)
    finally:
        M.ec.scan_proj = real
    want = GRUMPKIN.pyref_spec.identity_affine()
    for p, k in zip(pts, ks):
        want = want + k * p
    assert decode_points(GRUMPKIN, out)[0] == want
    assert sorted(seen.items()) == sorted(M.scan_proj_launches(n, c or M.default_window(n)))


# lane_group's choice at the 13 chunk counts of one secondary commit's MSM
# (78982 points, c = 16), and K4's at one lane and at 2^16 lanes
_K2 = ((65552, 1), (39504, 1), (32784, 1), (19760, 2), (16400, 2), (9888, 2), (8208, 2),
       (4944, 2), (4112, 4), (2480, 4), (2064, 8), (1248, 8), (1040, 8))


def test_lane_groups_at_the_commit_shapes():
    assert [C_ for (_, C_), _ in M.scan_proj_launches(78982, 16)] == [C_ for C_, _ in _K2]
    for C_, g in _K2:
        assert ec.lane_group("scan_proj", GRUMPKIN, C_) == g
    assert set(ec.groups("scan_proj", GRUMPKIN)) == {1, 2, 4, 8}
    assert ec.lane_group("map_pdouble", GRUMPKIN, 1) == 4
    assert ec.lane_group("map_pdouble", GRUMPKIN, 1 << 16) == 1

"""The port's Fq12 tower ops (P3 `f12_map`'s plain version on the CPU, one
call over two lanes) against the JAX package's jitted ops
(`kogarashi_tpu/ops/pairing.py` :383-385 `f12_*_jit`, with `f12_frobenius`,
`f12_conj` and `f12_mul_by_034` jitted as tests/test_pairing_device.py does)
and the pyref tower, exactly. Values cross between the packages as ints."""

import jax
import numpy as np
import pytest
import torch

from kogarashi_tpu.ops import pairing as jp
from kogarashi_tpu_torch import constants as C
from kogarashi_tpu_torch.ops import pairing as P
from kogarashi_tpu_torch.pyref import Fq, Fq2, Fq12
from test_torch_pairing import ints12, jax_fq12, rand_fq12s

torch.set_num_threads(2)  # the suite runs several workers side by side


def coeff_words(cs):
    """[(c0, c3, c4) Fq2s] -> (48, n) words, the P3 mul_by_034 operand."""
    flat = [Fq12.from_fq_list([f for c in trio for f in (c.c0, c.c1)] + [Fq(0)] * 6) for trio in cs]
    return P.encode_fq12(flat, "cpu")[:48].contiguous()


def jax_fq2(v):
    return jp.encode_fq12(jax_fq12(Fq12.from_fq_list([v.c0, v.c1] + [Fq(0)] * 10)))[0][0]


@pytest.fixture(scope="module")
def lanes():
    xs, ys = rand_fq12s(1, 2), rand_fq12s(2, 2)
    rng = np.random.default_rng(3)
    cs = [[Fq2.new(*(int.from_bytes(rng.bytes(32), "little") % C.Q for _ in range(2))) for _ in range(3)]
          for _ in xs]
    return xs, ys, cs


# op -> (the port's call on (a, b, c), the pyref op on (x, y, c), the JAX
# package's call on (da, db, dc))
OPS = {
    "mul": (lambda a, b, c: P.f12_mul(a, b), lambda x, y, c: x * y, lambda da, db, dc: jp.f12_mul_jit(da, db)),
    "sq": (lambda a, b, c: P.f12_sq(a), lambda x, y, c: x.square(), lambda da, db, dc: jp.f12_sq_jit(da)),
    "inv": (lambda a, b, c: P.f12_inv(a), lambda x, y, c: x.invert(), lambda da, db, dc: jp.f12_inv_jit(da)),
    "conj": (lambda a, b, c: P.f12_conj(a), lambda x, y, c: x.conjugate(),
             lambda da, db, dc: jax.jit(jp.f12_conj)(da)),
    "mul_by_034": (lambda a, b, c: P.f12_mul_by_034(a, c), lambda x, y, c: x.mul_by_034(*c),
                   lambda da, db, dc: jax.jit(jp.f12_mul_by_034)(da, *dc)),
    **{f"frobenius{k}": (lambda a, b, c, k=k: P.f12_frobenius(a, k), lambda x, y, c, k=k: x.frobenius(k),
                         lambda da, db, dc, k=k: jax.jit(jp.f12_frobenius, static_argnums=1)(da, k))
       for k in (1, 2, 6)},
}


@pytest.mark.parametrize("op", list(OPS))
def test_tower_op_matches_jax_and_pyref(lanes, op):
    xs, ys, cs = lanes
    port, oracle, jax_op = OPS[op]
    a, b = P.encode_fq12(xs, "cpu"), P.encode_fq12(ys, "cpu")
    got = P.decode_fq12(port(a, b, coeff_words(cs)))
    assert got == [oracle(x, y, c) for x, y, c in zip(xs, ys, cs)]
    for x, y, c, g in zip(xs, ys, cs, got):
        want = jax_op(jp.encode_fq12(jax_fq12(x)), jp.encode_fq12(jax_fq12(y)), [jax_fq2(v) for v in c])
        assert ints12(jp.decode_fq12(want)) == ints12(g)


def test_encode_decode_round_trip(lanes):
    """encode_fq12 / decode_fq12 on one element (96,) and on a batch
    (96, n), and the JAX package's encoding of the same values."""
    xs, _, _ = lanes
    assert P.decode_fq12(P.encode_fq12(xs[0], "cpu")) == xs[0]
    batch = P.encode_fq12(xs, "cpu")
    assert batch.shape == (96, len(xs)) and P.decode_fq12(batch) == xs
    assert ints12(jp.decode_fq12(jp.encode_fq12(jax_fq12(xs[1])))) == ints12(P.decode_fq12(batch[:, 1]))

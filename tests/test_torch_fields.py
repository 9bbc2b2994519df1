"""Port field engine (kogarashi_tpu_torch.fields) against the JAX package's
field layers and the port's own pyref oracle. Integer arithmetic: exact
equality."""

import re
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kogarashi_tpu import constants as C
from kogarashi_tpu.fields import mont as jmont
from kogarashi_tpu.fields import mont_pallas as M
from kogarashi_tpu.fields.spec import FQ as JFQ, FR as JFR
from kogarashi_tpu_torch import interop
from kogarashi_tpu_torch.fields import mont
from kogarashi_tpu_torch.fields.spec import FQ, FR, ints_to_words, words_to_ints
from kogarashi_tpu_torch.pyref import Fq, Fq2

torch.set_num_threads(2)  # the suite runs several workers side by side

CSRC = Path(__file__).resolve().parent.parent / "kogarashi_tpu_torch" / "csrc"
SPECS = {"fr": (FR, JFR, jmont.FR_OPS), "fq": (FQ, JFQ, jmont.FQ_OPS)}


def rand_ints(p, n, seed):
    raw = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [int.from_bytes(r.astype("<u4").tobytes(), "little") % p for r in raw]
    return [0, 1, p - 1] + vals[3:]


def enc(spec, vals):
    return torch.from_numpy(spec.encode(vals))


def test_layout_roundtrip():
    w = torch.from_numpy(np.random.default_rng(0).integers(-(1 << 31), 1 << 31, (8, 64), dtype=np.int32))
    assert torch.equal(mont.to_words(mont.to_halves(w)), w)
    vals = rand_ints(FQ.p, 16, 1)
    assert words_to_ints(ints_to_words(vals)) == vals


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_encode_matches_jax_layout(name):
    spec, jspec, ops = SPECS[name]
    vals = rand_ints(spec.p, 32, 2)
    assert np.array_equal(spec.encode(vals), interop.words_from_limbs16(np.asarray(ops.encode(vals))))


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg"])
@pytest.mark.parametrize("name", ["fr", "fq"])
def test_ops_match_jax_mont(name, op):
    """Same inputs through kogarashi_tpu.fields.mont (run eagerly) and the
    port: identical words."""
    spec, jspec, ops = SPECS[name]
    a, b = rand_ints(spec.p, 32, 3), rand_ints(spec.p, 32, 4)[::-1]
    A, B = ops.encode(a), ops.encode(b)
    jop = {"mul": ops.mul, "sqr": ops.square, "add": ops.add, "sub": ops.sub, "neg": ops.neg}[op]
    with jax.disable_jit():
        want = jop(A, B) if op in ("mul", "add", "sub") else jop(A)
    args = (enc(spec, a), enc(spec, b)) if op in ("mul", "add", "sub") else (enc(spec, a),)
    got = getattr(mont, op)(*args, spec=spec)
    assert np.array_equal(got.numpy(), interop.words_from_limbs16(np.asarray(want)))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_ops_vs_pyref(name):
    spec = SPECS[name][0]
    p = spec.p
    a, b = rand_ints(p, 48, 5), rand_ints(p, 48, 6)
    A, B = enc(spec, a), enc(spec, b)
    dec = lambda t: spec.decode(t.numpy())
    assert dec(mont.mul(A, B, spec=spec)) == [x * y % p for x, y in zip(a, b)]
    assert dec(mont.sqr(A, spec=spec)) == [x * x % p for x in a]
    assert dec(mont.add(A, B, spec=spec)) == [(x + y) % p for x, y in zip(a, b)]
    assert dec(mont.sub(A, B, spec=spec)) == [(x - y) % p for x, y in zip(a, b)]
    assert dec(mont.neg(A, spec=spec)) == [-x % p for x in a]
    assert dec(mont.inv(A[:, :8], spec=spec)) == [pow(x, -1, p) if x else 0 for x in a[:8]]
    assert words_to_ints(mont.to_std(A, spec).numpy()) == a
    assert dec(mont.from_std(torch.from_numpy(ints_to_words(a)), spec)) == a


def test_fq2_vs_pyref():
    p = FQ.p
    a = list(zip(rand_ints(p, 24, 7), rand_ints(p, 24, 8)[::-1]))
    b = list(zip(rand_ints(p, 24, 9), rand_ints(p, 24, 10)))
    enc2 = lambda v: torch.cat([enc(FQ, [x[0] for x in v]), enc(FQ, [x[1] for x in v])])

    def dec2(t):
        return [Fq2(Fq(u), Fq(v)) for u, v in zip(FQ.decode(t[:8].numpy()), FQ.decode(t[8:].numpy()))]

    pa = [Fq2(Fq(x), Fq(y)) for x, y in a]
    pb = [Fq2(Fq(x), Fq(y)) for x, y in b]
    A, B = enc2(a), enc2(b)
    assert dec2(mont.mul(A, B, spec=FQ, ext=2)) == [x * y for x, y in zip(pa, pb)]
    assert dec2(mont.sqr(A, spec=FQ, ext=2)) == [x * x for x in pa]
    assert dec2(mont.add(A, B, spec=FQ, ext=2)) == [x + y for x, y in zip(pa, pb)]
    assert dec2(mont.sub(A, B, spec=FQ, ext=2)) == [x - y for x, y in zip(pa, pb)]
    assert dec2(mont.neg(A, spec=FQ, ext=2)) == [-x for x in pa]
    inv = dec2(mont.inv(A[:, 3:9], spec=FQ, ext=2))
    assert all(x * y == Fq2.one() for x, y in zip(pa[3:9], inv))


def test_mul_matches_mont_pallas():
    """The TPU kernels' 13-bit R' = 2^260 engine (`M.mm`, `M.sqr`, run as
    plain jnp) and the port agree once `interop` moves the radix."""
    K = M.MontConsts.make(JFQ)
    p = K.p
    a, b = rand_ints(p, 16, 11), rand_ints(p, 16, 12)

    def enc13(vals):
        return np.array([M.limbs13(v * K.mont_r % p, K.n) for v in vals], np.int32).T

    A13, B13 = jnp.asarray(enc13(a)), jnp.asarray(enc13(b))
    mm = np.asarray(M.canonical(M.mm(A13, B13, K), K, 2))
    sq = np.asarray(M.canonical(M.sqr(A13, K), K, 2))
    from260 = lambda rows: interop.from_mont260(rows, FQ, device="cpu")
    assert torch.equal(from260(mm.T), mont.mul(enc(FQ, a), enc(FQ, b), spec=FQ))
    assert torch.equal(from260(sq.T), mont.sqr(enc(FQ, a), spec=FQ))
    assert torch.equal(from260(enc13(a).T), enc(FQ, a))


def _hex_words(src: str, after: str, count: int):
    tail = src[src.index(after):]
    return [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", tail)[:count]]


def _as_int(words):
    return sum(w << (32 * i) for i, w in enumerate(words))


@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_csrc_field_constants(name):
    """The constants written into csrc/field.cuh are the field's."""
    spec = {"Fq": FQ, "Fr": FR}[name]
    src = (CSRC / "field.cuh").read_text()
    block = src[src.index(f"struct {name} {{"):]
    assert int(re.search(r"inv = 0x([0-9a-f]+)u", block).group(1), 16) == spec.inv32
    assert _as_int(_hex_words(block, "p(int i)", 8)) == spec.p
    assert _as_int(_hex_words(block, "one(int i)", 8)) == spec.r1


def test_csrc_curve_constants():
    """G1's mul_b3, a chain of field adds, multiplies by 3b; G2's b3
    constant, in Montgomery form, is 3b."""
    src = (CSRC / "ec.cu").read_text()
    r = 1 << 256
    g1 = src[src.index("struct G1 {"):src.index("struct G2 {")]
    body = re.search(r"mul_b3\(const A::E& x\) \{(.*?)\n  \}", g1, re.S).group(1)
    assert "mul" not in body  # adds only
    env = {"add": lambda a, b: a + b, "x": 1}
    exec(textwrap.dedent(body).replace("A::E ", "").replace("A::add", "add").replace("return", "b3 ="), env)
    assert env["b3"] == 3 * C.G1_B
    g2 = _hex_words(src, "struct G2 {", 16)
    assert _as_int(g2[:8]) == 3 * C.G2_B[0] * r % C.Q
    assert _as_int(g2[8:]) == 3 * C.G2_B[1] * r % C.Q

"""Carry JAX-package arrays (as numpy) into the port's word layout.

Two source layouts exist in `kogarashi_tpu`:
  * 16-bit limbs, Montgomery R = 2^256 (`fields/mont.py`, e.g. the R1CS
    coefficients): a pure repack, two limbs per 32-bit word;
  * 13-bit limb rows, Montgomery R' = 2^260 (`fields/mont_pallas.py`, the
    MSM's query rows (n, 20 * ext)): repack the value into words, then one
    Montgomery multiply by 2^252 mod p, since
    x * 2^260 * 2^252 * 2^-256 = x * 2^256.

`params_from_jax` turns the JAX package's Groth16 `Parameters` into the
port's, so both provers can run on the same keys; `public_params_from_jax`
and `recursive_proof_from_jax` do the same for Nova's public parameters and
recursive proofs, so both packages can fold with the same keys;
`edwards_from_jax` carries Jubjub points and `fq12_from_jax` Fq12s. This module
takes numpy arrays, points by their integer coordinates, R1CS rows by their
(wire, coefficient) terms and drivers by name; it imports nothing of the JAX
package. Points are rebuilt as the port's own pyref points, so the port's
verifiers take them.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves import G1, G2, GRUMPKIN
from .devices import resolve
from .fields import mont
from .fields.spec import FQ, FieldSpec, ints_to_words
from .groth16.keys import Parameters, VerifyingKey
from .nova import function
from .nova.ivc import PublicParams
from .nova.pedersen import PedersenCommitment
from .nova.proof import RecursiveProof
from .nova.relaxed_r1cs import (
    R1csInstance,
    R1csShape,
    R1csWitness,
    RelaxedR1csInstance,
    RelaxedR1csWitness,
)
from .pyref import AffinePoint
from .r1cs import BN254_DRIVER, GRUMPKIN_DRIVER, LinComb


def words_from_limbs16(a) -> np.ndarray:
    """(16, ...) 16-bit limbs -> (8, ...) int32 words (same value)."""
    a = np.asarray(a).astype(np.uint32)
    return (a[0::2] | (a[1::2] << 16)).view(np.int32)


def edwards_from_jax(p, device=None):
    """A JAX Edwards point batch (x, y, t, z), each (16, n) or (16,) 16-bit
    Montgomery limbs (R = 2^256, `kogarashi_tpu/curves/edwards.py`) -> the
    port's (X, Y, T, Z), each (8, n) int32 words, on `device` (None: the
    card)."""
    device = resolve(device)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(words_from_limbs16(np.asarray(c).reshape(16, -1)))).to(device)
        for c in p)


def fq12_from_jax(a, device=None):
    """A JAX device Fq12 (`kogarashi_tpu/ops/pairing.py`), shape
    (2, 3, 2, 16, *batch) of 16-bit Montgomery limbs (R = 2^256) -> the
    port's (96, *batch) int32 words (`ops/pairing.py`: 12 Fq components in
    `Fq12.to_fq_list` order, 8 words each), on `device` (None: the card)."""
    device = resolve(device)
    a = np.asarray(a)
    if a.shape[:4] != (2, 3, 2, 16):
        raise ValueError(f"expected (2, 3, 2, 16, ...) limbs, got {a.shape}")
    w = np.moveaxis(words_from_limbs16(np.moveaxis(a, 3, 0)), 0, 3)  # (2, 3, 2, 8, *batch)
    return torch.from_numpy(np.ascontiguousarray(w.reshape(96, *a.shape[4:]))).to(device)


def words_from_limbs13(a) -> np.ndarray:
    """(20, ...) 13-bit limbs (value < 2^256) -> (8, ...) int32 words."""
    a = np.asarray(a).astype(np.uint64)
    out = np.zeros((8,) + a.shape[1:], np.uint64)
    for i in range(a.shape[0]):
        for k in range(8):
            shift = 13 * i - 32 * k
            if -13 < shift < 32:
                part = a[i] << np.uint64(shift) if shift >= 0 else a[i] >> np.uint64(-shift)
                out[k] |= part & np.uint64(0xFFFFFFFF)
    return out.astype(np.uint32).view(np.int32)


def from_mont260(rows13, spec: FieldSpec, ext: int = 1, device=None):
    """(n, 20 * ext) 13-bit R' = 2^260 Montgomery rows -> (8 * ext, n)
    R = 2^256 Montgomery words on `device` (None: the card)."""
    device = resolve(device)
    rows13 = np.asarray(rows13)
    n = rows13.shape[0]
    comps = rows13.reshape(n, ext, 20)
    raise_r = torch.from_numpy(ints_to_words([(1 << 252) % spec.p]))
    out = []
    for e in range(ext):
        w = torch.from_numpy(np.ascontiguousarray(words_from_limbs13(comps[:, e].T))).to(device)
        out.append(mont.mul(w, raise_r.to(device), spec=spec))
    return torch.cat(out)


def query_from_jax(rows, ext: int, device=None):
    """JAX MSM query (x_rows, y_rows, inf, gen_xy) -> port (x, y, inf) on
    `device` (None: the card)."""
    device = resolve(device)
    x_rows, y_rows, inf, _ = rows
    return (from_mont260(x_rows, FQ, ext, device), from_mont260(y_rows, FQ, ext, device),
            torch.from_numpy(np.asarray(inf, bool).copy()).to(device))


def port_point(curve, q) -> AffinePoint:
    """An affine point with integer-valued coordinates (`.v`, or `.c0.v` and
    `.c1.v` over Fq2) and `is_infinity` -> the port's pyref point."""
    spec = curve.pyref_spec
    if q.is_infinity:
        return spec.identity_affine()
    make = spec.field if curve.ext == 1 else spec.field.new
    return AffinePoint(spec, make(*curve.comps(q.x)), make(*curve.comps(q.y)), False)


def params_from_jax(jp, device=None) -> Parameters:
    """`kogarashi_tpu.groth16.keys.Parameters` (arrays as numpy or anything
    `np.asarray` takes) -> the port's `Parameters` on `device` (None: the
    card)."""
    device = resolve(device)
    mats = [
        dict(
            row=torch.from_numpy(np.asarray(m["row"], np.int64)).to(device),
            col=torch.from_numpy(np.asarray(m["col"], np.int64)).to(device),
            coeff=torch.from_numpy(np.ascontiguousarray(words_from_limbs16(m["coeff"]))).to(device),
        )
        for m in jp.mats
    ]
    vk = jp.vk
    return Parameters(
        vk=VerifyingKey(
            alpha_g1=port_point(G1, vk.alpha_g1),
            beta_g1=port_point(G1, vk.beta_g1),
            beta_g2=port_point(G2, vk.beta_g2),
            gamma_g2=port_point(G2, vk.gamma_g2),
            delta_g1=port_point(G1, vk.delta_g1),
            delta_g2=port_point(G2, vk.delta_g2),
            ic=[port_point(G1, q) for q in vk.ic],
        ),
        h=query_from_jax(jp.h, 1, device),
        l=query_from_jax(jp.l, 1, device),
        a=query_from_jax(jp.a, 1, device),
        b_g1=query_from_jax(jp.b_g1, 1, device),
        b_g2=query_from_jax(jp.b_g2, 2, device),
        l_pub=jp.l_pub,
        n=jp.n,
        mats=mats,
        num_wires=jp.num_wires,
    )


# ---------------------------------------------------------------------------
# Nova
# ---------------------------------------------------------------------------


DRIVERS = {d.name: d for d in (BN254_DRIVER, GRUMPKIN_DRIVER)}


def commit_point(driver, q) -> AffinePoint:
    """A point on `driver`'s commitment curve, by integer coordinates."""
    return port_point(G1 if driver.commit_curve.name == "G1" else GRUMPKIN, q)


def shape_from_jax(js, device=None):
    """A JAX `R1csShape` -> the port's, its rows rebuilt from their
    (wire, coefficient) terms, its products on `device` (None: the card)."""
    driver = DRIVERS[js.driver.name]
    p = driver.scalar.p
    rows = [[LinComb(p, dict(row.terms)) for row in getattr(js, k)] for k in ("a", "b", "c")]
    return R1csShape(driver=driver, m=js.m, instance_length=js.instance_length,
                     witness_length=js.witness_length, a=rows[0], b=rows[1], c=rows[2],
                     device=resolve(device))


def public_params_from_jax(pp, device=None):
    """`kogarashi_tpu.nova.PublicParams` -> the port's, on `device` (None:
    the card): both shapes, both Pedersen keys (their materialized points,
    by integer coordinates) and the step functions, taken by class name
    from `nova.function`."""
    device = resolve(device)
    shapes = [shape_from_jax(s, device) for s in (pp.shape_primary, pp.shape_secondary)]
    keys = []
    for shape, ck in zip(shapes, (pp.ck_primary, pp.ck_secondary)):
        spec = shape.driver.commit_curve
        keys.append(PedersenCommitment.from_points(
            spec, ck.key_len, [commit_point(shape.driver, q) for q in ck.g], device))

    def step(fc):
        if not hasattr(function, fc.__name__):
            raise ValueError(f"no step function {fc.__name__} in kogarashi_tpu_torch.nova.function")
        return getattr(function, fc.__name__)

    return PublicParams(shape_primary=shapes[0], shape_secondary=shapes[1], ck_primary=keys[0],
                        ck_secondary=keys[1], fc_primary=step(pp.fc_primary),
                        fc_secondary=step(pp.fc_secondary))


def instance_from_jax(driver, u):
    """A JAX `R1csInstance` whose commitment lies on `driver`'s commitment
    curve -> the port's."""
    return R1csInstance(commit_w=commit_point(driver, u.commit_w), x=[int(v) for v in u.x])


def relaxed_instance_from_jax(u):
    """A JAX `RelaxedR1csInstance` -> the port's (its driver by name)."""
    driver = DRIVERS[u.driver.name]
    return RelaxedR1csInstance(driver=driver, commit_w=commit_point(driver, u.commit_w),
                               commit_e=commit_point(driver, u.commit_e), u=int(u.u),
                               x=[int(v) for v in u.x])


def recursive_proof_from_jax(proof):
    """`kogarashi_tpu.nova.RecursiveProof` -> the port's."""
    u_range_secondary = relaxed_instance_from_jax(proof.u_range_secondary)
    return RecursiveProof(
        i=proof.i,
        z0_primary=[int(v) for v in proof.z0_primary],
        z0_secondary=[int(v) for v in proof.z0_secondary],
        zi_primary=[int(v) for v in proof.zi_primary],
        zi_secondary=[int(v) for v in proof.zi_secondary],
        u_single_secondary=instance_from_jax(u_range_secondary.driver, proof.u_single_secondary),
        w_single_secondary=R1csWitness(w=[int(v) for v in proof.w_single_secondary.w]),
        u_range_primary=relaxed_instance_from_jax(proof.u_range_primary),
        w_range_primary=RelaxedR1csWitness(w=[int(v) for v in proof.w_range_primary.w],
                                           e=[int(v) for v in proof.w_range_primary.e]),
        u_range_secondary=u_range_secondary,
        w_range_secondary=RelaxedR1csWitness(w=[int(v) for v in proof.w_range_secondary.w],
                                             e=[int(v) for v in proof.w_range_secondary.e]),
    )

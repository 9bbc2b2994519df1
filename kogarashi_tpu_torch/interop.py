"""Carry JAX-package arrays (as numpy) into the port's word layout.

Two source layouts exist in `kogarashi_tpu`:
  * 16-bit limbs, Montgomery R = 2^256 (`fields/mont.py`, e.g. the R1CS
    coefficients): a pure repack, two limbs per 32-bit word;
  * 13-bit limb rows, Montgomery R' = 2^260 (`fields/mont_pallas.py`, the
    MSM's query rows (n, 20 * ext)): repack the value into words, then one
    Montgomery multiply by 2^252 mod p, since
    x * 2^260 * 2^252 * 2^-256 = x * 2^256.

`params_from_jax` turns the JAX package's Groth16 `Parameters` into the
port's, so both provers can run on the same keys. This module takes numpy
arrays, and points by their integer coordinates; it imports nothing of the
JAX package. The verifying key's points are rebuilt as the port's own pyref
points, so the port's verifier takes them.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves import G1, G2
from .devices import resolve
from .fields import mont
from .fields.spec import FQ, FieldSpec, ints_to_words
from .groth16.keys import Parameters, VerifyingKey
from .pyref import AffinePoint


def words_from_limbs16(a) -> np.ndarray:
    """(16, ...) 16-bit limbs -> (8, ...) int32 words (same value)."""
    a = np.asarray(a).astype(np.uint32)
    return (a[0::2] | (a[1::2] << 16)).view(np.int32)


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


"""Groth16 proofs of the square-chain circuit, worked out in closed form.

The circuit (`configs/groth16-bn254-2p20.json`): m constraints over BN254's
Fr, m - 2 squarings w_{j+1} = w_j^2 from the public seed x0 = w_0 to the
public output w_{m-2}, and two rows 1 * 1 = 1 on the constant wire. Row j
reads wire in(j) on A and B and writes out(j) on C; the wires are
z = (1, x0, out, w_1 ... w_{m-3}).

With the toxic waste (alpha, beta, gamma, delta, tau) known, every query
point is a known multiple of a generator, so a proof is three scalars:

    A = alpha + sum_i z_i u_i(tau) + r delta                       (G1)
    B = beta  + sum_i z_i v_i(tau) + s delta                       (G2)
    C = (sum_{i private} z_i (beta u_i + alpha v_i + w_i)(tau)
         + h(tau) t(tau)) / delta + s A + r B - r s delta          (G1)

where u_i(tau) = sum_j A_ji L_j(tau) over the Lagrange basis of the 2^k-point
domain (L_j(X) = 0 at every omega^i but omega^j, where it is 1), and
h(tau) t(tau) = A(tau) B(tau) - C(tau) for a satisfying witness. No NTT, no
MSM: O(m) products of Python integers a proof.
"""

from __future__ import annotations

import operator

from .ec import G1, G2, R

FR_TWO_ADICITY = 28
FR_GENERATOR = 7  # the multiplicative generator that fixes BN254 Fr's roots of unity


def toxic_waste(rng):
    """(alpha, beta, gamma, delta, tau), drawn in Groth16's order."""
    return tuple(rng.randrange(1, R) for _ in range(5))


def blinding(rng):
    """(r, s), as the prover draws them for one proof."""
    return rng.randrange(R), rng.randrange(R)


def domain_size(m: int) -> int:
    return 1 << (m - 1).bit_length() if m > 1 else 2


def lagrange_at(tau: int, n: int, count: int) -> list[int]:
    """L_j(tau) for j < count on the n-point domain of omega = 7^((R-1)/n):
    (tau^n - 1) omega^j / (n (tau - omega^j)), with one batch inversion."""
    k = n.bit_length() - 1
    omega = pow(FR_GENERATOR, (R - 1) >> k, R)
    assert pow(omega, n, R) == 1 and pow(omega, n // 2, R) != 1
    pw = [1] * count
    for j in range(1, count):
        pw[j] = pw[j - 1] * omega % R
    den = [(tau - w) % R for w in pw]
    pre = [1] * count
    acc = 1
    for j in range(count):
        pre[j] = acc
        acc = acc * den[j] % R
    inv = pow(acc, -1, R)
    c = (pow(tau, n, R) - 1) * pow(n, -1, R) % R
    out = [0] * count
    for j in range(count - 1, -1, -1):
        out[j] = c * pw[j] % R * (inv * pre[j] % R) % R
        inv = inv * den[j] % R
    return out


class SquareChainProofs:
    """Reference proofs for one setup: `proof(x0, r, s)` -> (A, B, C) as
    affine tuples (G2's coordinates (c0, c1) pairs)."""

    def __init__(self, m: int, waste):
        self.m = m
        self.alpha, self.beta, self.gamma, self.delta, tau = waste
        self.lag = lagrange_at(tau, domain_size(m), m)

    def scalars(self, x0: int, r: int, s: int):
        m, lag = self.m, self.lag
        mc = m - 2
        chain = [x0 % R] * (mc + 1)
        v = chain[0]
        for j in range(1, mc + 1):
            v = v * v % R
            chain[j] = v
        pad = (lag[mc] + lag[mc + 1]) % R
        a_tau = (sum(map(operator.mul, chain[:mc], lag[:mc])) + pad) % R  # = v_i sums: A == B
        c_tau = (sum(map(operator.mul, chain[1:], lag[:mc])) + pad) % R
        a_priv = (a_tau - chain[0] * lag[0] - pad) % R
        c_priv = (c_tau - chain[mc] * lag[mc - 1] - pad) % R
        alpha, beta, delta = self.alpha, self.beta, self.delta
        k_priv = ((beta + alpha) * a_priv + c_priv) % R
        ht = (a_tau * a_tau - c_tau) % R
        a_s = (alpha + a_tau + r * delta) % R
        b_s = (beta + a_tau + s * delta) % R
        c_s = ((k_priv + ht) * pow(delta, -1, R) + s * a_s + r * b_s - r * s % R * delta) % R
        return a_s, b_s, c_s

    def proof(self, x0: int, r: int, s: int, bits: int | None = None):
        """The proof's points; `bits` keeps only the scalars' low bits (the
        control: the same proof at a lower precision)."""
        a_s, b_s, c_s = self.scalars(x0, r, s)
        if bits is not None:
            a_s, b_s, c_s = (v & ((1 << bits) - 1) for v in (a_s, b_s, c_s))
        return G1.mul(a_s), G2.mul(b_s), G1.mul(c_s)

"""Plain short-Weierstrass arithmetic (y^2 = x^3 + b) for the references:
BN254 G1 over Fq, G2 over Fq2 = Fq[u]/(u^2 + 1), and Grumpkin over Fr.

Points are affine tuples (x, y) or None for the identity; Fq2 elements are
(c0, c1) tuples. Scalar multiplication runs in Jacobian coordinates.
Constants are BN254's (EIP-196/197) and Grumpkin's published ones.
"""

from __future__ import annotations

Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


class Fp:
    def __init__(self, p: int):
        self.p = p
        self.zero, self.one = 0, 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def inv(self, a):
        return pow(a, -1, self.p)


class Fp2:
    """Fq[u]/(u^2 + 1)."""

    def __init__(self, p: int):
        self.p = p
        self.zero, self.one = (0, 0), (1, 0)

    def add(self, a, b):
        return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)

    def mul(self, a, b):
        p = self.p
        return ((a[0] * b[0] - a[1] * b[1]) % p, (a[0] * b[1] + a[1] * b[0]) % p)

    def inv(self, a):
        p = self.p
        d = pow((a[0] * a[0] + a[1] * a[1]) % p, -1, p)
        return (a[0] * d % p, -a[1] * d % p)


class Curve:
    def __init__(self, name, field, b, generator, order):
        self.name, self.F, self.b, self.generator, self.order = name, field, b, generator, order

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        F = self.F
        x, y = pt
        return F.mul(y, y) == F.add(F.mul(F.mul(x, x), x), self.b)

    def _double(self, P):
        F = self.F
        X, Y, Z = P
        if Z == F.zero:
            return P
        A = F.mul(X, X)
        B = F.mul(Y, Y)
        C = F.mul(B, B)
        t = F.add(X, B)
        D = F.sub(F.sub(F.mul(t, t), A), C)
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        X3 = F.sub(F.mul(E, E), F.add(D, D))
        C8 = F.add(C, C)
        C8 = F.add(C8, C8)
        C8 = F.add(C8, C8)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        Z3 = F.mul(F.add(Y, Y), Z)
        return (X3, Y3, Z3)

    def _add(self, P, Qp):
        F = self.F
        if P[2] == F.zero:
            return Qp
        if Qp[2] == F.zero:
            return P
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Qp
        Z1Z1, Z2Z2 = F.mul(Z1, Z1), F.mul(Z2, Z2)
        U1, U2 = F.mul(X1, Z2Z2), F.mul(X2, Z1Z1)
        S1, S2 = F.mul(F.mul(Y1, Z2), Z2Z2), F.mul(F.mul(Y2, Z1), Z1Z1)
        if U1 == U2:
            return self._double(P) if S1 == S2 else (F.one, F.one, F.zero)
        H = F.sub(U2, U1)
        Rr = F.sub(S2, S1)
        HH = F.mul(H, H)
        HHH = F.mul(H, HH)
        V = F.mul(U1, HH)
        X3 = F.sub(F.sub(F.mul(Rr, Rr), HHH), F.add(V, V))
        Y3 = F.sub(F.mul(Rr, F.sub(V, X3)), F.mul(S1, HHH))
        Z3 = F.mul(F.mul(Z1, Z2), H)
        return (X3, Y3, Z3)

    def _jac(self, pt):
        F = self.F
        return (F.one, F.one, F.zero) if pt is None else (pt[0], pt[1], F.one)

    def _aff(self, P):
        F = self.F
        if P[2] == F.zero:
            return None
        zi = F.inv(P[2])
        zi2 = F.mul(zi, zi)
        return (F.mul(P[0], zi2), F.mul(F.mul(P[1], zi2), zi))

    def mul(self, k: int, pt=None):
        """k * pt (default: the generator), k reduced mod the group order."""
        pt = self.generator if pt is None else pt
        k %= self.order
        acc, base = self._jac(None), self._jac(pt)
        for bit in bin(k)[2:]:
            acc = self._double(acc)
            if bit == "1":
                acc = self._add(acc, base)
        return self._aff(acc)


G1 = Curve("G1", Fp(Q), 3, (1, 2), R)
G2 = Curve(
    "G2",
    Fp2(Q),
    # b / (9 + u), the D-type twist of b = 3
    (0x2B149D40CEB8AAAE81BE18991BE06AC3B5B4C5E559DBEFA33267E6DC24A138E5,
     0x009713B03AF0FED4CD2CAFADEED8FDF4A74FA084E52D1852E4A2BD0685C315D2),
    ((0x1800DEEF121F1E76426A00665E5C4479674322D4F75EDADD46DEBD5CD992F6ED,
      0x198E9393920D483A7260BFB731FB5D25F1AA493335A9E71297E485B7AEF312C2),
     (0x12C85EA5DB8C6DEB4AAB71808DCB408FE3D1E7690C43D37B4CE6CC0166FA7DAA,
      0x090689D0585FF075EC9E99AD690C3395BC4B313370B38EF355ACDADCD122975B)),
    R,
)
# Grumpkin: y^2 = x^3 - 17 over Fr, group order Q; its generator (1, y),
# y = sqrt(-16) as the upstream project (grumpkin/src/params.rs) picks it.
GRUMPKIN = Curve("Grumpkin", Fp(R), (-17) % R,
                 (1, 0x2CF135E7506A45D632D270D45F1181294833FC48D823F272C), Q)
for _c in (G1, G2, GRUMPKIN):
    assert _c.on_curve(_c.generator), _c.name

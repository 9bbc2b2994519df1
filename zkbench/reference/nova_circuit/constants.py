"""BN254 and Jubjub constants the port reads, as plain Python ints.

The port's own copy of the part of `kogarashi_tpu/constants.py` it uses (the
port imports nothing of `kogarashi_tpu`); names and values are the same, and
tests/test_torch_host.py holds them equal.

Parity (reference = KogarashiNetwork/Kogarashi, Rust):
  - Fr modulus: bn254/src/fr.rs:11-51; multiplicative generator 7, S = 28
  - Fq modulus: bn254/src/fq.rs:9-44; multiplicative generator 3
  - BN_X: bn254/src/params.rs:4
  - G1 generator (1, 2), b = 3: bn254/src/params.rs:8-12
  - G2 generator and twist b: bn254/src/params.rs:15-57
  - Grumpkin b = -17 and generator (1, y): grumpkin/src/params.rs:5-10
  - MiMC rounds and transcript widths: nova/src/hash.rs:7-13
  - BigNat limbs: nova/src/gadget/big_nat.rs:8-9
  - BLS12-381 Fr and Jubjub (d, order, cofactor, generator):
    zkstd/tests/jubjub.rs
  - BLS12-381 Fq: zkstd/src/arithmetic/limbs/bits_384
"""

# Base field of BN254 G1
Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
# Scalar field of BN254
R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001

# BN parameter x; the optimal-ate Miller loop runs over 6x + 2
BN_X = 4965661367192848881
assert Q == 36 * BN_X**4 + 36 * BN_X**3 + 24 * BN_X**2 + 6 * BN_X + 1
assert R == 36 * BN_X**4 + 36 * BN_X**3 + 18 * BN_X**2 + 6 * BN_X + 1
SIX_X_PLUS_2 = 6 * BN_X + 2


def two_adicity(p: int):
    """(s, t) with p - 1 = 2^s t, t odd."""
    s, t = 0, p - 1
    while t % 2 == 0:
        t //= 2
        s += 1
    return s, t


FR_S, FR_T = two_adicity(R)  # S = 28
FQ_S, FQ_T = two_adicity(Q)  # S = 1
FR_GENERATOR = 7
FQ_GENERATOR = 3
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, FR_T, R)  # 2^S-th root of unity
FQ_ROOT_OF_UNITY = pow(FQ_GENERATOR, FQ_T, Q)
assert FR_ROOT_OF_UNITY == 0x03DDB9F5166D18B798865EA93DD31F743215CF6DD39329C8D34F1ED960C37C9C

# G1: y^2 = x^3 + 3 over Fq
G1_B = 3
G1_GEN = (1, 2)

# Grumpkin: y^2 = x^3 - 17 over Fr (its scalar field is Fq), the 2-cycle
# partner of G1. The reference's generator (1, y) takes the root whose
# Montgomery limbs (R = 2^256) grumpkin/src/params.rs:6-10 lists.
GRUMPKIN_B = (-17) % R
GRUMPKIN_GEN = (
    1,
    0x14B34CF69DC25D68AA7B8CF435DFAFBB23D3446F21C77DC311B2DFF1448C41D8 * pow(1 << 256, -1, R) % R,
)
assert (GRUMPKIN_GEN[1] ** 2 - GRUMPKIN_GEN[0] ** 3 - GRUMPKIN_B) % R == 0

# G2: y^2 = x^3 + 3/(9 + u) over Fq2 = Fq[u]/(u^2 + 1) (D-type twist);
# coordinates are (c0, c1) pairs meaning c0 + c1 u
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)
FQ2_XI = (9, 1)  # xi = 9 + u, the sextic non-residue


def _fq2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def _fq2_inv(a):
    n = pow(a[0] * a[0] + a[1] * a[1], -1, Q)
    return (a[0] * n % Q, -a[1] * n % Q)


G2_B = _fq2_mul((3, 0), _fq2_inv(FQ2_XI))
_lhs = _fq2_mul(G2_GEN_Y, G2_GEN_Y)
_rhs = _fq2_mul(_fq2_mul(G2_GEN_X, G2_GEN_X), G2_GEN_X)
assert _lhs == ((_rhs[0] + G2_B[0]) % Q, (_rhs[1] + G2_B[1]) % Q)

# MiMC (nova/src/hash.rs:7-13)
MIMC_ROUNDS = 46
CHALLENGE_BITS = 128
HASH_BITS = 252

# Nova BigNat gadget limb layout (nova/src/gadget/big_nat.rs:8-9)
BN_LIMB_WIDTH = 64
BN_N_LIMBS = 4

# Jubjub over the BLS12-381 scalar field (zkstd/tests/jubjub.rs fixture):
# twisted Edwards -x^2 + y^2 = 1 + d x^2 y^2 (a = -1), d = -(10240/10241).
# The base curve of RedDSA signatures.

# BLS12-381 scalar field (Jubjub's base field), 255 bits
BLS_FR = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS_FR_GENERATOR = 7  # multiplicative generator (jubjub.rs BLS_SCALAR_GENERATOR = 7*R)
BLS_FR_S, BLS_FR_T = two_adicity(BLS_FR)
assert BLS_FR_S == 32  # zkstd/tests/jubjub.rs: S = 32
BLS_FR_ROOT_OF_UNITY = pow(BLS_FR_GENERATOR, BLS_FR_T, BLS_FR)

# Jubjub prime-order subgroup order (= its scalar field; jubjub.rs
# JUBJUB_MODULUS), cofactor 8
JUBJUB_ORDER = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7
JUBJUB_COFACTOR = 8

# d = -(10240/10241) mod BLS_FR (jubjub.rs EDWARDS_D raw limbs)
JUBJUB_D = (-10240 * pow(10241, -1, BLS_FR)) % BLS_FR
assert JUBJUB_D == 0x2A9318E74BFA2B48F5FD9207E6BD7FD4292D7F6D37579D2601065FD6D6343EB1

# Generator of the prime-order subgroup (jubjub.rs X/Y raw limbs)
JUBJUB_GEN = (
    0x3FD2814C43AC65A6F1FBF02D0FD6CCE62E3EBB21FD6C54ED4DF7B7FFEC7BEACA,
    0x12,
)
_jx, _jy = JUBJUB_GEN
assert (-_jx * _jx + _jy * _jy - 1 - JUBJUB_D * _jx * _jx % BLS_FR * _jy * _jy) % BLS_FR == 0

# BLS12-381 base field (384-bit width; zkstd/src/arithmetic/limbs/bits_384 and
# the bls12_381_field fixture in zkstd/tests/jubjub.rs): the plain field
# engine at 12 words (fields/spec.py `BLS_FQ`)
BLS_FQ = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
assert BLS_FQ.bit_length() == 381

// 256-bit Montgomery field arithmetic for the port's CUDA kernels: BN254's
// Fq and Fr, and BLS12-381's Fr.
//
// Replaces the in-kernel limb engine of the TPU kernels,
// kogarashi_tpu/fields/mont_pallas.py (`mm` :171, `sqr` :214,
// modadd/modsub/neg/cond_sub :143-250), and the Fq2 algebra `Fq2AlgK`
// (kogarashi_tpu/ops/ec_pallas.py:94-167). These are __device__ functions,
// not launches.
//
// Layout: an element is 8 little-endian 32-bit words, Montgomery form with
// R = 2^256 (the reference's radix). Fq2 = Fq[u]/(u^2 + 1) is c0 then c1.
//
// The multiply: CIOS (Koc et al.) over 32-bit words, written on the PTX
// carry flag (mad.lo.cc / madc.hi.cc / addc.cc) in the manner of Emmart,
// Luitjens, Weems and Woolley, "Optimizing Modular Multiplication for
// NVIDIA's Maxwell GPUs" (ARITH 2016). One row x * y (x = a or the modulus,
// y = one word) puts lo(x_j y) in column j and hi(x_j y) in column j + 1, so
// the products of the even words x_0, x_2, x_4, x_6 cover columns 0-7 with no
// overlap, one carry chain of 8 multiply-adds, and those of the odd words
// columns 1-8, a second chain. The running value is kept as two arrays,
// t = X + 2^32 Y: X holds the even chains' sums (X[k] in column k), Y the odd
// chains' (Y[k] in column k + 1), and they are added once, at the end. Each
// lo/hi pair of a chain then reads and writes one fixed pair of registers,
// which the card does in one 64-bit multiply-add (IMAD.WIDE) with no moves in
// between; one running value would pair its words differently in the two
// chains and pay a move per word to re-pair them.
//
// Row i: m_i = X[0] * (-p^-1) mod 2^32 (column 0 is X[0] alone); Y += m_i p_odd;
// X += m_i p_even, whose carry out of column 7 goes to Y[7] (column 8). X[0] is
// then 0, and the division by 2^32 swaps the roles: the old Y is the new X
// (its words now in columns 0-7), the old X[2..7] is the new Y (columns 1-6),
// and the old X[1] (new column 0) is added to the new X[0] with add.cc, whose
// carry, of column 1, is the carry-in of the next odd chain, which starts at
// column 1 and writes the new Y from the old X[2..7] (rows 1-7 fold the shift
// into that chain). Each chain is one asm statement, so the carry flag never
// lives across compiler-scheduled code. A multiply is 8 rows of 4 x 8
// multiply-adds plus the 8 digits m_i: the 264 multiply-adds the bound counts
// (ops/ec.py), of which ptxas fuses each lo/hi pair into one IMAD.WIDE.
//
// Bound argument (every function returns a canonical value in [0, p)). It
// needs only p < 2^255, so that 2p < 2^256; nothing below depends on which p
// it is. The fields:
//   * BN254's q (G1's and G2's base field) and r (Grumpkin's base field):
//     top word 0x30644e72 < 2^30, so p < 2^254 and 2p < 2^255, a bit to spare.
//   * BLS12-381's scalar field (Jubjub's base field, `BlsFr`): top word
//     0x73eda753 < 2^31, so p < 2^255 and 2p < 2^256, no bit to spare. The
//     argument below never used the spare bit; for this p each step is
//     re-derived where it reads the margin.
//   * mont_mul, with a, b < p. Before row i the running value is t < 2p
//     (t = 0 before row 0). Row i adds a * b_i <= (2^32 - 1) p and
//     m_i * p <= (2^32 - 1) p, so every partial sum is below
//     2p + 2 (2^32 - 1) p < 2^33 p, which for p < 2^255 is below 2^288 =
//     columns 0-8 (BN254: below 2^287). t = X + 2^32 Y with X, Y >= 0, so
//     Y <= t / 2^32 < 2^256: no chain on Y carries out of Y[7], whose chains
//     end in a madc.hi with no carry out, and the carry X passes to Y[7] does
//     not overflow it. m_i makes column 0 zero; dropping it gives
//     t' = (t + a b_i + m_i p) / 2^32 < (2p + 2 (2^32 - 1) p) / 2^32 < 2p.
//     After row 7 the final add Y + X / 2^32 is that t' < 2p < 2^256, so
//     merge_rows' dropped carry out of word 7 is 0, and one conditional
//     subtract of p gives [0, p). The sequence was checked word by word,
//     carry flags included, against integer arithmetic before it was built.
//   * add: a + b < 2p < 2^256, so fp_add's dropped carry out of word 7 is 0;
//     one conditional subtract. sub: a - b, adding p back when it borrows,
//     lands in [0, p) (the add-back's carry out is dropped: it is the
//     borrow's 2^256). neg(a) = sub(0, a), so 0 maps to 0.
//   * No function sums more than two values before it reduces: a kernel's
//     3x, 8x, 9x or 51x is a chain of canonical adds, and Edwards' a = -1
//     negations are canonical subtracts (csrc/edwards.cu).
//   * chip_smoke.py's field phase and tests/test_torch_cuda.py hold the
//     engine exact against the plain version (fields/mont.py) on every pair
//     of edge values of each field: 0, 1, p - 1, p - 2, R mod p, values with
//     p's top word, and values just below p.
// There are no lazily reduced values anywhere: the TPU engine's bounded
// "< 8p" bookkeeping (mont_pallas.py:20-34) is not needed, and every kernel's
// output equals its plain version's (fields/mont.py) bit for bit.
//
// What bounds it on an H100: 32-bit integer multiply-adds, 264 per multiply,
// at 64 per SM per clock (NVIDIA's table; csrc/imad_probe.cu measures the
// card's IMAD and IMAD.WIDE issue); and, for the Fq2 point formulas,
// registers. The code is straight-line after unrolling, so all limbs live in
// registers; constants fold into immediates.

#pragma once
#include <cstddef>
#include <cstdint>

namespace kt {

typedef uint32_t u32;

// BN254 base field q.
struct Fq {
  static constexpr u32 inv = 0xe4866389u;  // -q^-1 mod 2^32
  __device__ __forceinline__ static u32 p(int i) {
    constexpr u32 v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                          0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __device__ __forceinline__ static u32 one(int i) {  // R mod q
    constexpr u32 v[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                          0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

// BN254 scalar field r.
struct Fr {
  static constexpr u32 inv = 0xefffffffu;  // -r^-1 mod 2^32
  __device__ __forceinline__ static u32 p(int i) {
    constexpr u32 v[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                          0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __device__ __forceinline__ static u32 one(int i) {  // R mod r
    constexpr u32 v[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                          0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

// BLS12-381 scalar field, Jubjub's base field (csrc/edwards.cu).
struct BlsFr {
  static constexpr u32 inv = 0xffffffffu;  // -p^-1 mod 2^32
  __device__ __forceinline__ static u32 p(int i) {
    constexpr u32 v[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                          0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
    return v[i];
  }
  __device__ __forceinline__ static u32 one(int i) {  // R mod p
    constexpr u32 v[8] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                          0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
    return v[i];
  }
};

// ---------------------------------------------------------------------------
// Carry chains. Each is one asm statement: the carry flag is only valid
// inside one.
// ---------------------------------------------------------------------------

// X[0..7] += (x0, x2, x4, x6) * y as lo/hi pairs; the carry out of X[7]
// (column 8) goes into y7, the odd array's top word.
__device__ __forceinline__ void even_row(u32* X, u32& y7, u32 x0, u32 x2, u32 x4, u32 x6, u32 y) {
  asm("mad.lo.cc.u32  %0, %9,  %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9,  %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32       %8, %8,  0;"
      : "+r"(X[0]), "+r"(X[1]), "+r"(X[2]), "+r"(X[3]), "+r"(X[4]), "+r"(X[5]),
        "+r"(X[6]), "+r"(X[7]), "+r"(y7)
      : "r"(x0), "r"(x2), "r"(x4), "r"(x6), "r"(y));
}

// Y[0..7] += (x1, x3, x5, x7) * y as lo/hi pairs; no carry out of Y[7] (the
// bound argument above).
__device__ __forceinline__ void odd_row(u32* Y, u32 x1, u32 x3, u32 x5, u32 x7, u32 y) {
  asm("mad.lo.cc.u32  %0, %8,  %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8,  %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9,  %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9,  %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32    %7, %11, %12, %7;"
      : "+r"(Y[0]), "+r"(Y[1]), "+r"(Y[2]), "+r"(Y[3]), "+r"(Y[4]), "+r"(Y[5]),
        "+r"(Y[6]), "+r"(Y[7])
      : "r"(x1), "r"(x3), "r"(x5), "r"(x7), "r"(y));
}

// The division by 2^32 folded into row i's odd chain: nx0 (the new X[0],
// column 0) += X[1], and its carry enters NY = X[2..7] + (x1, x3, x5, x7) * y,
// the new odd array (columns 1-8). No carry out of NY[7].
__device__ __forceinline__ void odd_row_shifted(u32* NY, u32& nx0, const u32* X, u32 x1, u32 x3,
                                                u32 x5, u32 x7, u32 y) {
  asm("add.cc.u32     %8, %8,  %9;\n\t"
      "madc.lo.cc.u32 %0, %16, %20, %10;\n\t"
      "madc.hi.cc.u32 %1, %16, %20, %11;\n\t"
      "madc.lo.cc.u32 %2, %17, %20, %12;\n\t"
      "madc.hi.cc.u32 %3, %17, %20, %13;\n\t"
      "madc.lo.cc.u32 %4, %18, %20, %14;\n\t"
      "madc.hi.cc.u32 %5, %18, %20, %15;\n\t"
      "madc.lo.cc.u32 %6, %19, %20, 0;\n\t"
      "madc.hi.u32    %7, %19, %20, 0;"
      : "=r"(NY[0]), "=r"(NY[1]), "=r"(NY[2]), "=r"(NY[3]), "=r"(NY[4]), "=r"(NY[5]),
        "=r"(NY[6]), "=r"(NY[7]), "+r"(nx0)
      : "r"(X[1]), "r"(X[2]), "r"(X[3]), "r"(X[4]), "r"(X[5]), "r"(X[6]), "r"(X[7]),
        "r"(x1), "r"(x3), "r"(x5), "r"(x7), "r"(y));
}

// r = Y + X / 2^32 (X[0] is 0): the one add of the two arrays.
__device__ __forceinline__ void merge_rows(u32* r, const u32* X, const u32* Y) {
  asm("add.cc.u32  %0, %8,  %16;\n\t"
      "addc.cc.u32 %1, %9,  %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7])
      : "r"(Y[0]), "r"(Y[1]), "r"(Y[2]), "r"(Y[3]), "r"(Y[4]), "r"(Y[5]), "r"(Y[6]),
        "r"(Y[7]), "r"(X[1]), "r"(X[2]), "r"(X[3]), "r"(X[4]), "r"(X[5]), "r"(X[6]),
        "r"(X[7]));
}

// r = t - p and the borrow as a mask (0 or ~0), one chain.
template <class F>
__device__ __forceinline__ u32 sub_p(u32* r, const u32* t) {
  u32 bw;
  asm("sub.cc.u32  %0, %9,  %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7]), "=r"(bw)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]),
        "r"(t[7]), "r"(F::p(0)), "r"(F::p(1)), "r"(F::p(2)), "r"(F::p(3)),
        "r"(F::p(4)), "r"(F::p(5)), "r"(F::p(6)), "r"(F::p(7)));
  return bw;
}

// r = t if t < p else t - p, for t < 2p.
template <class F>
__device__ __forceinline__ void cond_sub_p(u32* r, const u32* t) {
  u32 d[8];
  const u32 bw = sub_p<F>(d, t);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = bw ? t[j] : d[j];
}

// Row i's reduction: m = X[0] * (-p^-1), then t += m p as two chains.
template <class F>
__device__ __forceinline__ void reduce_row(u32* X, u32* Y) {
  const u32 m = X[0] * F::inv;
  odd_row(Y, F::p(1), F::p(3), F::p(5), F::p(7), m);
  even_row(X, Y[7], F::p(0), F::p(2), F::p(4), F::p(6), m);
}

template <class F>
__device__ __forceinline__ void fp_mul(u32* r, const u32* a, const u32* b) {
  u32 X[8], Y[8];
  // row 0: each array's products land on distinct words, so no chain is needed
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    X[k] = a[k] * b[0];
    X[k + 1] = __umulhi(a[k], b[0]);
    Y[k] = a[k + 1] * b[0];
    Y[k + 1] = __umulhi(a[k + 1], b[0]);
  }
  reduce_row<F>(X, Y);
#pragma unroll
  for (int i = 1; i < 8; i++) {
    u32 NX[8], NY[8];
#pragma unroll
    for (int k = 0; k < 8; k++) NX[k] = Y[k];  // the old odd array, now columns 0-7
    odd_row_shifted(NY, NX[0], X, a[1], a[3], a[5], a[7], b[i]);
    even_row(NX, NY[7], a[0], a[2], a[4], a[6], b[i]);
    reduce_row<F>(NX, NY);
#pragma unroll
    for (int k = 0; k < 8; k++) {
      X[k] = NX[k];
      Y[k] = NY[k];
    }
  }
  u32 t[8];
  merge_rows(t, X, Y);
  cond_sub_p<F>(r, t);
}

template <class F>
__device__ __forceinline__ void fp_add(u32* r, const u32* a, const u32* b) {
  u32 t[8];
  asm("add.cc.u32  %0, %8,  %16;\n\t"
      "addc.cc.u32 %1, %9,  %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]), "=r"(t[5]),
        "=r"(t[6]), "=r"(t[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  cond_sub_p<F>(r, t);
}

template <class F>
__device__ __forceinline__ void fp_sub(u32* r, const u32* a, const u32* b) {
  u32 t[8], bw;
  asm("sub.cc.u32  %0, %9,  %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]), "=r"(t[5]),
        "=r"(t[6]), "=r"(t[7]), "=r"(bw)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  // add p back only when a < b
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7])
      : "r"(F::p(0) & bw), "r"(F::p(1) & bw), "r"(F::p(2) & bw), "r"(F::p(3) & bw),
        "r"(F::p(4) & bw), "r"(F::p(5) & bw), "r"(F::p(6) & bw), "r"(F::p(7) & bw));
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = t[j];
}

template <class F>
__device__ __forceinline__ void fp_neg(u32* r, const u32* a) {
  u32 z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  fp_sub<F>(r, z, a);
}

// ---------------------------------------------------------------------------
// Algebras: the point formulas in ec.cu are generic over these. Elements are
// passed by value, so no array ever has its address taken and every word
// stays in a register.
// ---------------------------------------------------------------------------

// T, in a parameter that must not deduce a template argument
template <class T>
struct Given {
  typedef T type;
};

template <int W>
struct Elem {
  u32 v[W];
};

// Base field (G1 over Fq).
template <class F>
struct Alg1 {
  typedef Elem<8> E;
  __device__ __forceinline__ static E mul(const E& a, const E& b) {
    E r;
    fp_mul<F>(r.v, a.v, b.v);
    return r;
  }
  __device__ __forceinline__ static E sqr(const E& a) { return mul(a, a); }
  __device__ __forceinline__ static E add(const E& a, const E& b) {
    E r;
    fp_add<F>(r.v, a.v, b.v);
    return r;
  }
  __device__ __forceinline__ static E sub(const E& a, const E& b) {
    E r;
    fp_sub<F>(r.v, a.v, b.v);
    return r;
  }
  __device__ __forceinline__ static E zero() {
    E r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = 0;
    return r;
  }
  __device__ __forceinline__ static E one() {
    E r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = F::one(j);
    return r;
  }
  // word k at a[k * plane + off]; I: the offsets' type, size_t unless a
  // caller that knows the words number less than 2^32 asks for u32
  template <class I = size_t>
  __device__ __forceinline__ static E load(const u32* __restrict__ a,
                                           typename Given<I>::type plane,
                                           typename Given<I>::type off) {
    E e;
#pragma unroll
    for (int k = 0; k < 8; k++) e.v[k] = a[k * plane + off];
    return e;
  }
  template <class I = size_t>
  __device__ __forceinline__ static void store(u32* __restrict__ a, typename Given<I>::type plane,
                                               typename Given<I>::type off, const E& e) {
#pragma unroll
    for (int k = 0; k < 8; k++) a[k * plane + off] = e.v[k];
  }
};

// One base-field multiply as a call. The Fq2 point formulas would otherwise
// inline some forty 8x8-word products per add. With the u64-column multiply
// of the port's first version that made cicc (the device front end) crash
// with a segmentation fault; with the carry chains it builds, at 252-255
// registers, but K3 G2 and K2 G2 ran slower than with the call (PERF.md).
// Arguments go by value, so the call keeps them in registers (no stack
// frame, no spills).
template <class F>
__device__ __noinline__ Elem<8> fp_mul_call(Elem<8> a, Elem<8> b) {
  Elem<8> r;
  fp_mul<F>(r.v, a.v, b.v);
  return r;
}

// Fermat inverse a^(p - 2), square-and-multiply from the top bit, on
// fp_mul_call; 0 maps to 0, as `fields/mont.py::Fp.inv` and
// kogarashi_tpu/fields/mont.py:209 do. The exponent's bits are constants, so
// the branch is the same for every lane. Canonical in, canonical out.
template <class F>
__device__ __noinline__ Elem<8> fp_inv(Elem<8> a) {
  u32 e[8];
  u32 borrow = 2;
#pragma unroll
  for (int j = 0; j < 8; j++) {  // e = p - 2
    const u32 pj = F::p(j);
    e[j] = pj - borrow;
    borrow = pj < borrow ? 1u : 0u;
  }
  Elem<8> r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = F::one(j);
#pragma unroll 1
  for (int bit = 255; bit >= 0; bit--) {
    r = fp_mul_call<F>(r, r);
    if ((e[bit >> 5] >> (bit & 31)) & 1u) r = fp_mul_call<F>(r, a);
  }
  return r;
}

// Fq2 = Fq[u]/(u^2 + 1): Karatsuba multiply (3 base multiplies).
template <class F>
struct Alg2 {
  typedef Alg1<F> B;
  struct E {
    Elem<8> c0, c1;
  };
  __device__ __forceinline__ static Elem<8> bmul(const Elem<8>& a, const Elem<8>& b) {
    return fp_mul_call<F>(a, b);
  }
  __device__ __forceinline__ static E mul(const E& a, const E& b) {
    Elem<8> m0 = bmul(a.c0, b.c0);
    Elem<8> m1 = bmul(a.c1, b.c1);
    Elem<8> m2 = bmul(B::add(a.c0, a.c1), B::add(b.c0, b.c1));
    E r;
    r.c0 = B::sub(m0, m1);
    r.c1 = B::sub(B::sub(m2, m0), m1);
    return r;
  }
  __device__ __forceinline__ static E sqr(const E& a) {
    E r;
    Elem<8> m = bmul(a.c0, a.c1);
    r.c0 = bmul(B::add(a.c0, a.c1), B::sub(a.c0, a.c1));
    r.c1 = B::add(m, m);
    return r;
  }
  __device__ __forceinline__ static E add(const E& a, const E& b) {
    E r;
    r.c0 = B::add(a.c0, b.c0);
    r.c1 = B::add(a.c1, b.c1);
    return r;
  }
  __device__ __forceinline__ static E sub(const E& a, const E& b) {
    E r;
    r.c0 = B::sub(a.c0, b.c0);
    r.c1 = B::sub(a.c1, b.c1);
    return r;
  }
  __device__ __forceinline__ static E zero() {
    E r;
    r.c0 = B::zero();
    r.c1 = B::zero();
    return r;
  }
  __device__ __forceinline__ static E one() {
    E r;
    r.c0 = B::one();
    r.c1 = B::zero();
    return r;
  }
  template <class I = size_t>
  __device__ __forceinline__ static E load(const u32* __restrict__ a,
                                           typename Given<I>::type plane,
                                           typename Given<I>::type off) {
    E e;
    e.c0 = B::template load<I>(a, plane, off);
    e.c1 = B::template load<I>(a + 8 * plane, plane, off);
    return e;
  }
  template <class I = size_t>
  __device__ __forceinline__ static void store(u32* __restrict__ a, typename Given<I>::type plane,
                                               typename Given<I>::type off, const E& e) {
    B::template store<I>(a, plane, off, e.c0);
    B::template store<I>(a + 8 * plane, plane, off, e.c1);
  }
};

}  // namespace kt

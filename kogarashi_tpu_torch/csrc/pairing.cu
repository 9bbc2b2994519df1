// BN254's Fq2/Fq6/Fq12 tower and the optimal-ate pairing's two device loops:
// the Groth16 verifier's pairing work on the card.
//
// These replace XLA programs, not Pallas kernels: kogarashi_tpu/ops/pairing.py
// is jitted jnp code (no Pallas kernel exists for it).
//   P1 pair_miller_loop <- :331 `_miller_scan`, a lax.scan over the folds of
//                          the NAF walk (91 for one pair): per fold, square
//                          the accumulator if the fold's flag says so, then
//                          one sparse line multiply (`f12_mul_by_034`) per
//                          live pair, with the host's scaled coefficients
//   P2 pair_final_exp   <- :360 `final_exp_device`: the easy part,
//                          conj(f) f^-1 then frob^2(t) t, and the hard part,
//                          square-and-multiply over the bits of
//                          HARD_PART_EXP from the lowest (`_HARD_BITS` :353)
//   P3 f12_map          <- :383-385 `f12_mul_jit` / `f12_sq_jit` /
//                          `f12_inv_jit`, :233 `f12_frobenius`, :204
//                          `f12_conj` and :213 `f12_mul_by_034`, one op
//                          over a batch of lanes, on one of two routes
// The port's plain engine would run P1 and P2 as hundreds of thousands of
// torch launches a pairing; each is one launch here.
//
// Formulas: the JAX package's (ops/pairing.py:47-260, fqn.rs): Karatsuba
// Fq6 and Fq12 multiplies (18 and 54 base multiplies), the Fq12 square on
// two Fq6 multiplies (36), the sparse line multiply (39), the inverse down
// the tower to one Fermat inverse in Fq (field.cuh `fp_inv`). Every field op
// is canonical (field.cuh), so each output equals the plain version's
// (ops/pairing.py) bit for bit. The Frobenius coefficients come from the
// host as Montgomery words (pyref/tower.py's tables): P3's as 12 powers x
// (FQ6_C1, FQ6_C2, FQ12_C1) x 16 words, P2's (power 2) among its schedule's
// constants.
//
// Layout: an Fq12 is 12 Fq components in `Fq12.to_fq_list` order (c0.c0.c0,
// c0.c0.c1, c0.c1.c0, ..., c1.c2.c1), 8 words each: (96, n) int32, word k of
// component j of lane c at (8 j + k) n + c. P1's coefficients are
// (n_folds, n_pairs, 3, 16): per fold and pair the three Fq2s c0, c1, c2 of
// the line, each c0's 8 words then c1's.
//
// What bounds them (ops/pairing.py `bound_ms`, `one_thread_floor_ms`,
// `depth_floor_ms`):
//   P1, P2: each fold and each bit needs the one before, so one block does
//     the whole product; the chip-wide bound (32-bit multiply-adds at 64 per
//     SM per clock on 132 SMs) is microseconds. Inside a tower op every Fq
//     product is independent of the others: a square is 36, a multiply 54,
//     a line 39, a set bit's multiply and the next square 90. So a block of
//     kPairT threads (96, the fastest of 32, 64 and 96 on an H100) runs the
//     op as one level: each thread forms its
//     product's two operands from the Fq components in shared memory (the
//     Karatsuba pre-additions, the multiplies by xi and by v, conjugation:
//     sums of small multiples of slots, each slot kept beside its negation
//     so that a sum only adds; kept unreduced and reduced once), makes one
//     inline Montgomery multiply and writes it to shared memory; a barrier;
//     groups of lanes rebuild the result's components from the products,
//     each lane a share of the terms, added across the group by shuffles; a
//     barrier. What the level computes is data, built and checked in Python
//     (ops/pairing_schedule.py) and handed over as one int32 table, so the
//     exact table the card reads is tested on the CPU
//     (tests/test_torch_pairing_schedule.py). The floor is then the levels'
//     chain (336 for P1 at 3 pairs, 771 for P2) at one dependent multiply
//     each, plus the easy part's one Fermat inverse in Fq (fp_inv, 366
//     multiplies through fp_mul_call), which one thread runs while the rest
//     wait at the barrier. P1 stages its line records into shared memory a
//     chunk at a time with cp.async, the next chunk in flight, so any number
//     of pairs fits. One thread alone would be held to the chain of all
//     12915 / 48970 multiplies (`one_thread_floor_ms`).
//   P3: two routes, picked by lane count (ops/pairing.py `P3_ROUTES`, from
//     profile_pairing.py's sweep on an H100). The schedule route
//     (f12_sched_kernel) runs the op's schedule (pairing_schedule.py
//     `f12_op`: a multiply is one level of 54 products, an inverse 7 levels
//     and the Fermat inverse) on a block of kPairT threads a lane, as P1 and
//     P2 run theirs: at the one lane the verify equation's Gt check launches,
//     one thread alone would run the whole chain of dependent multiplies
//     while every other SM sits idle. The thread route (f12_map_kernel) runs
//     one thread per lane; at many lanes the issue rate of the multiply-adds
//     bounds it. Its elements live in local memory: the tower's helpers below
//     are __noinline__ and take references, so the compiler keeps one Fq2
//     multiply's words in registers at a time (a fully inlined Fq12 multiply
//     would be 54 inlined products; field.cuh notes that inlining the Fq2
//     multiply alone once crashed the compiler).
// chip_smoke.py's build phase prints each kernel's registers, stack and
// spills.

#include <cuda_runtime.h>

#include "field.cuh"

namespace kt {

typedef Alg1<Fq> B1;
typedef Alg2<Fq> A2;
typedef A2::E F2;
typedef Elem<8> E1;

struct F6 {
  F2 c0, c1, c2;
};
struct F12 {
  F6 c0, c1;
};

constexpr int kPairThreads = 128;  // P3's block

// P1's and P2's block: 96 threads was the fastest of 32, 64 and 96 on an
// H100 (PERF.md); kogarashi_tpu_torch/profile_pairing.py builds and times
// each with -DKT_PAIR_T.
#ifndef KT_PAIR_T
#define KT_PAIR_T 96
#endif
constexpr int kPairT = KT_PAIR_T;

// ---------------------------------------------------------------------------
// Fq2
// ---------------------------------------------------------------------------

__device__ __noinline__ F2 f2_mul(F2 a, F2 b) { return A2::mul(a, b); }
__device__ __noinline__ F2 f2_sq(F2 a) { return A2::sqr(a); }
__device__ __forceinline__ F2 f2_add(const F2& a, const F2& b) { return A2::add(a, b); }
__device__ __forceinline__ F2 f2_sub(const F2& a, const F2& b) { return A2::sub(a, b); }
__device__ __forceinline__ F2 f2_neg(const F2& a) { return A2::sub(A2::zero(), a); }

__device__ __forceinline__ F2 f2_conj(const F2& a) {
  F2 r;
  r.c0 = a.c0;
  r.c1 = B1::sub(B1::zero(), a.c1);
  return r;
}

__device__ __forceinline__ E1 x9(const E1& x) {
  const E1 x2 = B1::add(x, x);
  const E1 x4 = B1::add(x2, x2);
  const E1 x8 = B1::add(x4, x4);
  return B1::add(x8, x);
}

// * xi = 9 + u: (9 a0 - a1, 9 a1 + a0)
__device__ __noinline__ F2 f2_mul_xi(F2 a) {
  F2 r;
  r.c0 = B1::sub(x9(a.c0), a.c1);
  r.c1 = B1::add(x9(a.c1), a.c0);
  return r;
}

// (a0 - a1 u) / (a0^2 + a1^2); 0 maps to 0
__device__ __noinline__ F2 f2_inv(F2 a) {
  const E1 n = fp_inv<Fq>(B1::add(fp_mul_call<Fq>(a.c0, a.c0), fp_mul_call<Fq>(a.c1, a.c1)));
  F2 r;
  r.c0 = fp_mul_call<Fq>(a.c0, n);
  r.c1 = B1::sub(B1::zero(), fp_mul_call<Fq>(a.c1, n));
  return r;
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v]/(v^3 - xi). Results go to r only after the last read of the
// operands, so r may be one of them.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void f6_add(F6& r, const F6& a, const F6& b) {
  r.c0 = f2_add(a.c0, b.c0);
  r.c1 = f2_add(a.c1, b.c1);
  r.c2 = f2_add(a.c2, b.c2);
}

__device__ __forceinline__ void f6_sub(F6& r, const F6& a, const F6& b) {
  r.c0 = f2_sub(a.c0, b.c0);
  r.c1 = f2_sub(a.c1, b.c1);
  r.c2 = f2_sub(a.c2, b.c2);
}

__device__ __forceinline__ void f6_neg(F6& r, const F6& a) {
  r.c0 = f2_neg(a.c0);
  r.c1 = f2_neg(a.c1);
  r.c2 = f2_neg(a.c2);
}

// * v: (xi c2, c0, c1)
__device__ __forceinline__ void f6_mul_nonres(F6& r, const F6& a) {
  const F2 t = f2_mul_xi(a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

__device__ __noinline__ void f6_mul(F6& r, const F6& a, const F6& b) {
  const F2 t0 = f2_mul(a.c0, b.c0);
  const F2 t1 = f2_mul(a.c1, b.c1);
  const F2 t2 = f2_mul(a.c2, b.c2);
  const F2 c0 = f2_add(
      t0, f2_mul_xi(f2_sub(f2_sub(f2_mul(f2_add(a.c1, a.c2), f2_add(b.c1, b.c2)), t1), t2)));
  const F2 c1 =
      f2_add(f2_sub(f2_sub(f2_mul(f2_add(a.c0, a.c1), f2_add(b.c0, b.c1)), t0), t1), f2_mul_xi(t2));
  const F2 c2 = f2_add(f2_sub(f2_sub(f2_mul(f2_add(a.c0, a.c2), f2_add(b.c0, b.c2)), t0), t2), t1);
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

// * (b0, b1, 0)
__device__ __noinline__ void f6_mul_by_01(F6& r, const F6& a, const F2& b0, const F2& b1) {
  const F2 t0 = f2_mul(a.c0, b0);
  const F2 t1 = f2_mul(a.c1, b1);
  const F2 c0 = f2_add(f2_mul_xi(f2_sub(f2_mul(f2_add(a.c1, a.c2), b1), t1)), t0);
  const F2 c2 = f2_add(f2_sub(f2_mul(f2_add(a.c0, a.c2), b0), t0), t1);
  const F2 c1 = f2_sub(f2_sub(f2_mul(f2_add(a.c0, a.c1), f2_add(b0, b1)), t0), t1);
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

__device__ __noinline__ void f6_inv(F6& r, const F6& a) {
  const F2 t0 = f2_sub(f2_sq(a.c0), f2_mul_xi(f2_mul(a.c1, a.c2)));
  const F2 t1 = f2_sub(f2_mul_xi(f2_sq(a.c2)), f2_mul(a.c0, a.c1));
  const F2 t2 = f2_sub(f2_sq(a.c1), f2_mul(a.c0, a.c2));
  const F2 d = f2_inv(
      f2_add(f2_mul(a.c0, t0), f2_mul_xi(f2_add(f2_mul(a.c2, t1), f2_mul(a.c1, t2)))));
  r.c0 = f2_mul(t0, d);
  r.c1 = f2_mul(t1, d);
  r.c2 = f2_mul(t2, d);
}

// ---------------------------------------------------------------------------
// Fq12 = Fq6[w]/(w^2 - v); r may be an operand, as above
// ---------------------------------------------------------------------------

__device__ __noinline__ void f12_mul(F12& r, const F12& a, const F12& b) {
  F6 t0, t1, s, u;
  f6_mul(t0, a.c0, b.c0);
  f6_mul(t1, a.c1, b.c1);
  f6_add(s, a.c0, a.c1);
  f6_add(u, b.c0, b.c1);
  f6_mul(s, s, u);
  f6_sub(s, s, t0);
  f6_sub(r.c1, s, t1);
  f6_mul_nonres(t1, t1);
  f6_add(r.c0, t0, t1);
}

__device__ __noinline__ void f12_sq(F12& r, const F12& a) {
  F6 t, s, u;
  f6_mul(t, a.c0, a.c1);
  f6_add(s, a.c0, a.c1);
  f6_mul_nonres(u, a.c1);
  f6_add(u, a.c0, u);
  f6_mul(s, s, u);
  f6_sub(s, s, t);
  f6_mul_nonres(u, t);
  f6_sub(r.c0, s, u);
  f6_add(r.c1, t, t);
}

__device__ __forceinline__ void f12_conj(F12& r, const F12& a) {
  r.c0 = a.c0;
  f6_neg(r.c1, a.c1);
}

__device__ __noinline__ void f12_inv(F12& r, const F12& a) {
  F6 s0, s1, d;
  f6_mul(s0, a.c0, a.c0);
  f6_mul(s1, a.c1, a.c1);
  f6_mul_nonres(s1, s1);
  f6_sub(s0, s0, s1);
  f6_inv(d, s0);
  f6_mul(s1, a.c1, d);
  f6_mul(r.c0, a.c0, d);
  f6_neg(r.c1, s1);
}

// * (c0, 0, 0, c3, c4, 0): the line (fqn.rs:570)
__device__ __noinline__ void f12_mul_by_034(F12& r, const F12& a, const F2& c0, const F2& c3,
                                            const F2& c4) {
  F6 t0, t1, t2, s;
  t0.c0 = f2_mul(a.c0.c0, c0);
  t0.c1 = f2_mul(a.c0.c1, c0);
  t0.c2 = f2_mul(a.c0.c2, c0);
  f6_mul_by_01(t1, a.c1, c3, c4);
  f6_add(s, a.c0, a.c1);
  f6_mul_by_01(t2, s, f2_add(c0, c3), c4);
  f6_mul_nonres(s, t1);
  f6_add(r.c0, s, t0);
  f6_sub(t2, t2, t0);
  f6_sub(r.c1, t2, t1);
}

__device__ __forceinline__ F2 load_f2(const u32* __restrict__ a, size_t plane, size_t off) {
  return A2::load(a, plane, off);
}

__device__ __forceinline__ F2 conj_if(const F2& x, bool odd) { return odd ? f2_conj(x) : x; }

// x -> x^(q^power), power in [0, 12); `table` holds, per power, FQ6_C1,
// FQ6_C2 and FQ12_C1 of that power (16 words each)
__device__ __noinline__ void f12_frobenius(F12& r, const F12& a, int power,
                                           const u32* __restrict__ table) {
  const u32* t = table + 48 * power;
  const F2 c1 = load_f2(t, 1, 0);
  const F2 c2 = load_f2(t + 16, 1, 0);
  const F2 w = load_f2(t + 32, 1, 0);
  const bool odd = power & 1;
  F12 o;
  o.c0.c0 = conj_if(a.c0.c0, odd);
  o.c0.c1 = f2_mul(conj_if(a.c0.c1, odd), c1);
  o.c0.c2 = f2_mul(conj_if(a.c0.c2, odd), c2);
  o.c1.c0 = f2_mul(conj_if(a.c1.c0, odd), w);
  o.c1.c1 = f2_mul(f2_mul(conj_if(a.c1.c1, odd), c1), w);
  o.c1.c2 = f2_mul(f2_mul(conj_if(a.c1.c2, odd), c2), w);
  r = o;
}

__device__ __forceinline__ void f12_load(F12& r, const u32* __restrict__ a, size_t plane,
                                         size_t off) {
  r.c0.c0 = load_f2(a, plane, off);
  r.c0.c1 = load_f2(a + 16 * plane, plane, off);
  r.c0.c2 = load_f2(a + 32 * plane, plane, off);
  r.c1.c0 = load_f2(a + 48 * plane, plane, off);
  r.c1.c1 = load_f2(a + 64 * plane, plane, off);
  r.c1.c2 = load_f2(a + 80 * plane, plane, off);
}

__device__ __forceinline__ void f12_store(u32* __restrict__ a, size_t plane, size_t off,
                                          const F12& x) {
  A2::store(a, plane, off, x.c0.c0);
  A2::store(a + 16 * plane, plane, off, x.c0.c1);
  A2::store(a + 32 * plane, plane, off, x.c0.c2);
  A2::store(a + 48 * plane, plane, off, x.c1.c0);
  A2::store(a + 64 * plane, plane, off, x.c1.c1);
  A2::store(a + 80 * plane, plane, off, x.c1.c2);
}

// ---------------------------------------------------------------------------
// P1, P2 and P3's schedule route: one block of kPairT threads runs a schedule
// (ops/pairing_schedule.py), level by level
// ---------------------------------------------------------------------------

// The schedule table's header and entries, as ops/pairing_schedule.py
// `_encode` writes them
enum {
  kHdrSlots = 0, kHdrLevels, kHdrLevelOff, kHdrConsts, kHdrConstOff, kHdrIn, kHdrOut,
  kHdrShared, kHdrProgram, kHdrProgramLen, kHdrZero, kHdrIn2, kHdrIn2Len
};
constexpr int kProdWords = 5, kOutWords = 3;
enum LevelKind { kLevel = 0, kInverse = 1, kLine = 2 };
constexpr int kLineWords = 48;  // one line record: c0, c3, c4
constexpr int kLineChunk = 16;  // records staged at a time (pairing_schedule.py LINE_CHUNK)

// A sum of c_i x_i over Fq values x_i <= q (a slot or its negation q -
// slot, so every c_i > 0), kept unreduced as x + 2^32 y: x the rows of the
// even words (columns 0-8), y those of the odd words (y[k] in column k + 1),
// as field.cuh's multiply keeps its running value, so a term's two chains
// are independent. The schedule keeps the sum of c_i at most 2^14, so the
// sum stays below 2^14 q < 2^268: no chain carries out of x[8] or y[7].
struct Wide {
  u32 x[9];
  u32 y[8];
};

__device__ __forceinline__ void wide_zero(Wide& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    a.x[k] = 0;
    a.y[k] = 0;
  }
  a.x[8] = 0;
}

// a += c x, x the Fq at src
__device__ __forceinline__ void wide_term(Wide& a, const u32* __restrict__ src, u32 c) {
  const uint4 lo = reinterpret_cast<const uint4*>(src)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(src)[1];
  even_row(a.x, a.x[8], lo.x, lo.z, hi.x, hi.z, c);
  odd_row(a.y, lo.y, lo.w, hi.y, hi.w, c);
}

// a += b
__device__ __forceinline__ void wide_add(Wide& a, const Wide& b) {
  asm("add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, %8, %17;"
      : "+r"(a.x[0]), "+r"(a.x[1]), "+r"(a.x[2]), "+r"(a.x[3]), "+r"(a.x[4]), "+r"(a.x[5]),
        "+r"(a.x[6]), "+r"(a.x[7]), "+r"(a.x[8])
      : "r"(b.x[0]), "r"(b.x[1]), "r"(b.x[2]), "r"(b.x[3]), "r"(b.x[4]), "r"(b.x[5]),
        "r"(b.x[6]), "r"(b.x[7]), "r"(b.x[8]));
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(a.y[0]), "+r"(a.y[1]), "+r"(a.y[2]), "+r"(a.y[3]), "+r"(a.y[4]), "+r"(a.y[5]),
        "+r"(a.y[6]), "+r"(a.y[7])
      : "r"(b.y[0]), "r"(b.y[1]), "r"(b.y[2]), "r"(b.y[3]), "r"(b.y[4]), "r"(b.y[5]),
        "r"(b.y[6]), "r"(b.y[7]));
}

// s = x + 2^32 y, 9 words
__device__ __forceinline__ void wide_merge(u32* s, const Wide& a) {
  s[0] = a.x[0];
  asm("add.cc.u32  %0, %8,  %16;\n\t"
      "addc.cc.u32 %1, %9,  %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]), "=r"(s[6]), "=r"(s[7]),
        "=r"(s[8])
      : "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(a.x[4]), "r"(a.x[5]), "r"(a.x[6]),
        "r"(a.x[7]), "r"(a.x[8]), "r"(a.y[0]), "r"(a.y[1]), "r"(a.y[2]), "r"(a.y[3]),
        "r"(a.y[4]), "r"(a.y[5]), "r"(a.y[6]), "r"(a.y[7]));
}

// s += o, 9 words
__device__ __forceinline__ void add9(u32* s, const u32* o) {
  asm("add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, %8, %17;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]), "+r"(s[6]),
        "+r"(s[7]), "+r"(s[8])
      : "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]),
        "r"(o[8]));
}

// r = s mod q, canonical, for s (9 words) < 2^14 q. With h = floor(s /
// 2^224) and q_7 q's top word, e = floor(h / (q_7 + 1)) <= s / q (since q <
// (q_7 + 1) 2^224), and s / q - e < (h + 1) / q_7 - h / (q_7 + 1) + 1 <
// 2.001 for h < 2^44, so s - e q lies in [0, 3q), below 2^256: two
// conditional subtracts finish it.
__device__ __forceinline__ void reduce9(u32* r, const u32* s) {
  u32 ep[9];
  const unsigned long long h = ((unsigned long long)s[8] << 32) | s[7];
  const u32 e = (u32)(h / ((unsigned long long)Fq::p(7) + 1));
  Wide m;
  wide_zero(m);
  even_row(m.x, m.x[8], Fq::p(0), Fq::p(2), Fq::p(4), Fq::p(6), e);
  odd_row(m.y, Fq::p(1), Fq::p(3), Fq::p(5), Fq::p(7), e);
  wide_merge(ep, m);
  u32 t[8], t2[8];
  asm("sub.cc.u32  %0, %8,  %16;\n\t"
      "subc.cc.u32 %1, %9,  %17;\n\t"
      "subc.cc.u32 %2, %10, %18;\n\t"
      "subc.cc.u32 %3, %11, %19;\n\t"
      "subc.cc.u32 %4, %12, %20;\n\t"
      "subc.cc.u32 %5, %13, %21;\n\t"
      "subc.cc.u32 %6, %14, %22;\n\t"
      "subc.u32    %7, %15, %23;"
      : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]), "=r"(t[5]), "=r"(t[6]),
        "=r"(t[7])
      : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]), "r"(s[7]),
        "r"(ep[0]), "r"(ep[1]), "r"(ep[2]), "r"(ep[3]), "r"(ep[4]), "r"(ep[5]), "r"(ep[6]),
        "r"(ep[7]));
  cond_sub_p<Fq>(t2, t);
  cond_sub_p<Fq>(r, t2);
}

__device__ __forceinline__ void wide_reduce(u32* r, const Wide& a) {
  u32 s[9];
  wide_merge(s, a);
  reduce9(r, s);
}

// Slot `slot` (of n_slots) := v, and its negation slot n_slots + slot :=
// q - v (q for 0: every value a sum reads is at most q)
__device__ __forceinline__ void slot_store(u32* S, int n_slots, int slot, const u32* v) {
  uint4* d = reinterpret_cast<uint4*>(S + 8 * slot);
  d[0] = make_uint4(v[0], v[1], v[2], v[3]);
  d[1] = make_uint4(v[4], v[5], v[6], v[7]);
  u32 n[8];
  asm("sub.cc.u32  %0, %8,  %16;\n\t"
      "subc.cc.u32 %1, %9,  %17;\n\t"
      "subc.cc.u32 %2, %10, %18;\n\t"
      "subc.cc.u32 %3, %11, %19;\n\t"
      "subc.cc.u32 %4, %12, %20;\n\t"
      "subc.cc.u32 %5, %13, %21;\n\t"
      "subc.cc.u32 %6, %14, %22;\n\t"
      "subc.u32    %7, %15, %23;"
      : "=r"(n[0]), "=r"(n[1]), "=r"(n[2]), "=r"(n[3]), "=r"(n[4]), "=r"(n[5]), "=r"(n[6]),
        "=r"(n[7])
      : "r"(Fq::p(0)), "r"(Fq::p(1)), "r"(Fq::p(2)), "r"(Fq::p(3)), "r"(Fq::p(4)),
        "r"(Fq::p(5)), "r"(Fq::p(6)), "r"(Fq::p(7)), "r"(v[0]), "r"(v[1]), "r"(v[2]),
        "r"(v[3]), "r"(v[4]), "r"(v[5]), "r"(v[6]), "r"(v[7]));
  uint4* dn = reinterpret_cast<uint4*>(S + 8 * (n_slots + slot));
  dn[0] = make_uint4(n[0], n[1], n[2], n[3]);
  dn[1] = make_uint4(n[4], n[5], n[6], n[7]);
}

// Where a thread's terms come from: the shared slots and their negations
// (below 2 n_slots), the current line record past them, and the zero
// slot's term (coefficient 0) that pads a chunk.
struct Terms {
  const u32* S;
  const u32* line;
  int n_slots, pad;
  __device__ __forceinline__ const u32* at(int t) const {
    const int slot = t & 0xffff;
    return slot < 2 * n_slots ? S + 8 * slot : line + 8 * (slot - 2 * n_slots);
  }
};

// Terms a thread loads and adds at a time: a chunk's loads go out together,
// and its terms' carry chains interleave.
constexpr int kTermChunk = 4;

// A level's products, one a thread (a thread takes k, k + kPairT, ... when there
// are more): both operands' sums side by side, a chunk of terms at a time (a
// term past an operand's count is the zero slot's), reduced, one inline
// multiply, to the product's slot and its negation.
__device__ __forceinline__ void level_products(const int* tab, const int* rows, int n,
                                               const Terms& src, u32* S) {
#pragma unroll 1
  for (int k = threadIdx.x; k < n; k += kPairT) {
    const int* e = rows + kProdWords * k;
    const int* ta = tab + e[1];
    const int* tb = tab + e[3];
    const int na = e[2], nb = e[4];
    Wide a, b;
    wide_zero(a);
    wide_zero(b);
#pragma unroll 1
    for (int i = 0; i < max(na, nb); i += kTermChunk) {
      int wa[kTermChunk], wb[kTermChunk];
#pragma unroll
      for (int u = 0; u < kTermChunk; u++) {
        wa[u] = i + u < na ? ta[i + u] : src.pad;
        wb[u] = i + u < nb ? tb[i + u] : src.pad;
      }
#pragma unroll
      for (int u = 0; u < kTermChunk; u++) {
        wide_term(a, src.at(wa[u]), (u32)wa[u] >> 16);
        wide_term(b, src.at(wb[u]), (u32)wb[u] >> 16);
      }
    }
    u32 x[8], y[8], m[8];
    wide_reduce(x, a);
    wide_reduce(y, b);
    fp_mul<Fq>(m, x, y);
    slot_store(S, src.n_slots, e[0], m);
  }
}

// A level's outputs, each on a group of G lanes of one warp (G the largest
// power of two up to 32 with n G <= kPairT): lane l sums the terms l, l + G, ...,
// a chunk at a time into two wide sums, merges them to 9 words, the group
// adds its sums by __shfl_xor_sync, and its first lane reduces and stores.
// Every thread of the block runs the same iterations, so every lane of a
// warp reaches each shuffle.
__device__ __forceinline__ void level_outputs(const int* tab, const int* rows, int n,
                                              const Terms& src, u32* S) {
  int G = 1;
  while (G < 32 && 2 * G * n <= kPairT) G *= 2;
  const int lane = threadIdx.x & (G - 1);
#pragma unroll 1
  for (int base = 0; base < n * G; base += kPairT) {
    const int j = (base + threadIdx.x) / G;
    const bool live = j < n;
    const int* e = rows + kOutWords * (live ? j : 0);
    const int* tt = tab + e[1];
    const int nt = live ? e[2] : 0;
    Wide a, b;
    wide_zero(a);
    wide_zero(b);
#pragma unroll 1
    for (int i = lane; i < nt; i += kTermChunk * G) {
      int w[kTermChunk];
#pragma unroll
      for (int u = 0; u < kTermChunk; u++) w[u] = i + u * G < nt ? tt[i + u * G] : src.pad;
#pragma unroll
      for (int u = 0; u < kTermChunk; u++) wide_term(u & 1 ? b : a, src.at(w[u]), (u32)w[u] >> 16);
    }
    wide_add(a, b);
    u32 s[9];
    wide_merge(s, a);
#pragma unroll 1
    for (int off = G / 2; off > 0; off >>= 1) {
      u32 o[9];
#pragma unroll
      for (int k = 0; k < 9; k++) o[k] = __shfl_xor_sync(0xffffffffu, s[k], off);
      add9(s, o);
    }
    if (live && lane == 0) {
      u32 r[8];
      reduce9(r, s);
      slot_store(S, src.n_slots, e[0], r);
    }
  }
}

// Copies `count` line records from `src` into shared memory at `dst`,
// asynchronously (cp.async, one group); 4 bytes a copy, so the caller's
// tensor needs no alignment beyond its words'.
__device__ __forceinline__ void stage_lines(u32* dst, const u32* __restrict__ src, int count) {
#pragma unroll 1
  for (int i = threadIdx.x; i < count * kLineWords; i += kPairT) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src + i) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Copies the table's first `words` ints (the table is padded to a multiple of
// 4, pairing_schedule.py `_encode`) into shared memory, 16 bytes a copy, a
// batch of loads in flight per thread.
constexpr int kCopyBatch = 4;
__device__ __forceinline__ void copy_table(int* tab, const int* __restrict__ sched, int words) {
  const int4* src = reinterpret_cast<const int4*>(sched);
  int4* dst = reinterpret_cast<int4*>(tab);
  const int n4 = (words + 3) / 4;
#pragma unroll 1
  for (int i = threadIdx.x; i < n4; i += kCopyBatch * kPairT) {
    int4 v[kCopyBatch];
#pragma unroll
    for (int u = 0; u < kCopyBatch; u++)
      if (i + u * kPairT < n4) v[u] = __ldg(src + i + u * kPairT);
#pragma unroll
    for (int u = 0; u < kCopyBatch; u++)
      if (i + u * kPairT < n4) dst[i + u * kPairT] = v[u];
  }
}

// Thread t < count writes Fq j = t of a lane's operand (word k of Fq j at
// in[(8 j + k) stride + lane]) to slot first + j and its negation.
__device__ __forceinline__ void load_operand(u32* S, int n_slots, int first, int count,
                                             const u32* __restrict__ in, size_t stride, int lane,
                                             int t) {
  if (first < 0 || t < 0 || t >= count) return;
  u32 v[8];
#pragma unroll
  for (int k = 0; k < 8; k++) v[k] = in[(size_t)(8 * t + k) * stride + lane];
  slot_store(S, n_slots, first + t, v);
}

// The schedule `sched` (device memory) on this block: its table (all but the
// program) into shared memory, the slots zeroed, the constants and the input
// operands (if the schedule takes them: `in` 12 Fq, `in2` the header's count)
// written, then the program's levels in order. `lines`: n_lines records,
// consumed one by each LINE level, staged kLineChunk at a time into two
// buffers, the next chunk in flight while this one is read. The output Fq12
// goes to `out`. Operands and output are lane `lane` of (rows, stride) words
// (P1, P2: stride 1, lane 0; P3: a block a lane).
__device__ __forceinline__ void run_schedule(const int* __restrict__ sched,
                                             const u32* __restrict__ in,
                                             const u32* __restrict__ in2,
                                             const u32* __restrict__ lines, int n_lines,
                                             u32* __restrict__ out, size_t stride, int lane) {
  extern __shared__ uint4 smem[];
  int* tab = reinterpret_cast<int*>(smem);
  const int shared_words = sched[kHdrShared];
  copy_table(tab, sched, shared_words);
  __syncthreads();
  const int n_slots = tab[kHdrSlots];
  u32* S = reinterpret_cast<u32*>(smem) + ((shared_words + 3) & ~3);
  u32* lbuf = S + 16 * n_slots;  // past the slots and their negations
#pragma unroll 1
  for (int i = threadIdx.x; i < 16 * n_slots; i += kPairT) S[i] = 0;
  __syncthreads();
  const int* consts = tab + tab[kHdrConstOff];
#pragma unroll 1
  for (int i = threadIdx.x; i < 8 * tab[kHdrConsts]; i += kPairT) {
    const int* c = consts + 9 * (i >> 3);
    S[8 * c[0] + (i & 7)] = (u32)c[1 + (i & 7)];
  }
  load_operand(S, n_slots, tab[kHdrIn], 12, in, stride, lane, (int)threadIdx.x);
  load_operand(S, n_slots, tab[kHdrIn2], tab[kHdrIn2Len], in2, stride, lane,
               (int)threadIdx.x - 12);
  if (n_lines > 0) stage_lines(lbuf, lines, min(kLineChunk, n_lines));
  __syncthreads();
  const int* levels = tab + tab[kHdrLevelOff];
  Terms src{S, lbuf, n_slots, tab[kHdrZero]};
  const int* program = sched + tab[kHdrProgram];
  const int n_prog = tab[kHdrProgramLen];
  int r = 0;  // line records consumed
#pragma unroll 1
  for (int pc = 0; pc < n_prog; pc++) {
    const int* lv = levels + 5 * __ldg(program + pc);
    if (lv[0] == kInverse) {
      if (threadIdx.x == 0) {
        Elem<8> v;
#pragma unroll
        for (int k = 0; k < 8; k++) v.v[k] = S[8 * lv[1] + k];
        v = fp_inv<Fq>(v);
        slot_store(S, n_slots, lv[2], v.v);
      }
      __syncthreads();
      continue;
    }
    if (lv[0] == kLine) {
      const int chunk = r / kLineChunk, at = r % kLineChunk;
      if (at == 0) {
        // this chunk has landed; every thread is past the chunk before it
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncthreads();
        const int next = r + kLineChunk;
        if (next < n_lines)
          stage_lines(lbuf + ((chunk + 1) & 1) * kLineChunk * kLineWords,
                         lines + (size_t)next * kLineWords, min(kLineChunk, n_lines - next));
      }
      src.line = lbuf + ((chunk & 1) * kLineChunk + at) * kLineWords;
      r++;
    }
    level_products(tab, tab + lv[2], lv[1], src, S);
    __syncthreads();
    level_outputs(tab, tab + lv[4], lv[3], src, S);
    __syncthreads();
  }
#pragma unroll 1
  for (int i = threadIdx.x; i < 96; i += kPairT)
    out[(size_t)i * stride + lane] = S[8 * tab[kHdrOut] + i];
}

// P1: the Miller loop's schedule over n_lines = n_folds x n_pairs line
// records (coeffs, (n_folds, n_pairs, 3, 16) words).
__global__ void __launch_bounds__(kPairT, 1)
    pair_miller_loop_kernel(const int* __restrict__ sched, const u32* __restrict__ coeffs,
                            int n_lines, u32* __restrict__ out) {
  run_schedule(sched, nullptr, nullptr, coeffs, n_lines, out, 1, 0);
}

// P2: the final exponentiation's schedule on f (96 words).
__global__ void __launch_bounds__(kPairT, 1)
    pair_final_exp_kernel(const int* __restrict__ sched, const u32* __restrict__ f,
                          u32* __restrict__ out) {
  run_schedule(sched, f, nullptr, nullptr, 0, out, 1, 0);
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <class K>
static int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// ---------------------------------------------------------------------------
// P3
// ---------------------------------------------------------------------------

enum F12Op { kMul = 0, kSq = 1, kInv = 2, kFrob = 3, kConj = 4, kMulBy034 = 5 };

// P3's thread route: one thread per lane. b: the second operand (96, n) for
// kMul, the line's (c0, c3, c4) as (48, n) for kMulBy034; unused otherwise.
template <int OP>
__global__ void __launch_bounds__(kPairThreads)
    f12_map_kernel(const u32* __restrict__ a, const u32* __restrict__ b,
                   const u32* __restrict__ frob, int power, u32* __restrict__ out, int n) {
  const int c = blockIdx.x * kPairThreads + threadIdx.x;
  if (c >= n) return;
  F12 x, r;
  f12_load(x, a, n, c);
  if (OP == kMul) {
    F12 y;
    f12_load(y, b, n, c);
    f12_mul(r, x, y);
  } else if (OP == kSq) {
    f12_sq(r, x);
  } else if (OP == kInv) {
    f12_inv(r, x);
  } else if (OP == kFrob) {
    f12_frobenius(r, x, power, frob);
  } else if (OP == kConj) {
    f12_conj(r, x);
  } else {
    const F2 c0 = load_f2(b, n, c);
    const F2 c3 = load_f2(b + 16 * (size_t)n, n, c);
    const F2 c4 = load_f2(b + 32 * (size_t)n, n, c);
    f12_mul_by_034(r, x, c0, c3, c4);
  }
  f12_store(out, n, c, r);
}

// P3's schedule route: the op's schedule (pairing_schedule.py `f12_op`) on
// one block of kPairT threads a lane, lane blockIdx.x of n. a: (96, n); b:
// the schedule's second operand, (96, n) for mul, (48, n) for mul_by_034.
__global__ void __launch_bounds__(kPairT)
    f12_sched_kernel(const int* __restrict__ sched, const u32* __restrict__ a,
                     const u32* __restrict__ b, u32* __restrict__ out, int n) {
  run_schedule(sched, a, b, nullptr, 0, out, n, blockIdx.x);
}

}  // namespace kt

using namespace kt;

// P1 and P2 on one block of kPairT threads; smem: the schedule's dynamic
// shared memory (ops/pairing_schedule.py `smem_bytes`).
extern "C" int kt_pair_miller_loop(const void* sched, const void* coeffs, int n_lines, int smem,
                                   void* out, void* stream) {
  const int rc = allow_smem(pair_miller_loop_kernel, smem);
  if (rc) return rc;
  pair_miller_loop_kernel<<<1, kPairT, smem, (cudaStream_t)stream>>>(
      (const int*)sched, (const u32*)coeffs, n_lines, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int kt_pair_final_exp(const void* sched, const void* f, int smem, void* out,
                                 void* stream) {
  const int rc = allow_smem(pair_final_exp_kernel, smem);
  if (rc) return rc;
  pair_final_exp_kernel<<<1, kPairT, smem, (cudaStream_t)stream>>>(
      (const int*)sched, (const u32*)f, (u32*)out);
  return (int)cudaGetLastError();
}

// The block size P1 and P2 launch with (this build's kPairT).
extern "C" int kt_pair_threads() { return kPairT; }

// P3 on the schedule route: n blocks of kPairT threads; smem: the schedule's
// dynamic shared memory.
extern "C" int kt_f12_sched(const void* sched, const void* a, const void* b, int smem, void* out,
                            int n, void* stream) {
  const int rc = allow_smem(f12_sched_kernel, smem);
  if (rc) return rc;
  f12_sched_kernel<<<n, kPairT, smem, (cudaStream_t)stream>>>((const int*)sched, (const u32*)a,
                                                              (const u32*)b, (u32*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int kt_f12_map(int op, const void* a, const void* b, const void* frob, int power,
                          void* out, int n, void* stream) {
  const int blocks = (n + kPairThreads - 1) / kPairThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const u32 *pa = (const u32*)a, *pb = (const u32*)b, *pf = (const u32*)frob;
  u32* po = (u32*)out;
  switch (op) {
    case kMul: f12_map_kernel<kMul><<<blocks, kPairThreads, 0, s>>>(pa, pb, pf, power, po, n); break;
    case kSq: f12_map_kernel<kSq><<<blocks, kPairThreads, 0, s>>>(pa, pb, pf, power, po, n); break;
    case kInv: f12_map_kernel<kInv><<<blocks, kPairThreads, 0, s>>>(pa, pb, pf, power, po, n); break;
    case kFrob: f12_map_kernel<kFrob><<<blocks, kPairThreads, 0, s>>>(pa, pb, pf, power, po, n); break;
    case kConj: f12_map_kernel<kConj><<<blocks, kPairThreads, 0, s>>>(pa, pb, pf, power, po, n); break;
    case kMulBy034:
      f12_map_kernel<kMulBy034><<<blocks, kPairThreads, 0, s>>>(pa, pb, pf, power, po, n);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

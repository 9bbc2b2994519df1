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
//                          (a template argument) over a batch of lanes
// The port's plain engine would run P1 and P2 as hundreds of thousands of
// torch launches a pairing; each is one launch here.
//
// Formulas: the JAX package's (ops/pairing.py:47-260, fqn.rs): Karatsuba
// Fq6 and Fq12 multiplies (18 and 54 base multiplies), the Fq12 square on
// two Fq6 multiplies (36), the sparse line multiply (39), the inverse down
// the tower to one Fermat inverse in Fq (field.cuh `fp_inv`). Every field op
// is canonical (field.cuh), so each output equals the plain version's
// (ops/pairing.py) bit for bit. The Frobenius coefficients come from the
// host as Montgomery words (pyref/tower.py's tables), 12 powers x (FQ6_C1,
// FQ6_C2, FQ12_C1) x 16 words.
//
// Layout: an Fq12 is 12 Fq components in `Fq12.to_fq_list` order (c0.c0.c0,
// c0.c0.c1, c0.c1.c0, ..., c1.c2.c1), 8 words each: (96, n) int32, word k of
// component j of lane c at (8 j + k) n + c. P1's coefficients are
// (n_folds, n_pairs, 3, 16): per fold and pair the three Fq2s c0, c1, c2 of
// the line, each c0's 8 words then c1's.
//
// What bounds them (ops/pairing.py `bound_ms`, `floor_ms`):
//   P1, P2: one thread runs the whole product, since each fold and each bit
//     needs the one before. The chip-wide bound (32-bit multiply-adds at 64
//     per SM per clock on 132 SMs) is microseconds; the floor is the chain of
//     Fq multiplies on that one thread, each a call (fp_mul_call) whose
//     dependent latency csrc/imad_probe.cu measures. On an H100 both take
//     about 3x that floor (PERF.md): the calls move their operands. Spreading
//     a product over a warp's lanes (as K4 does, csrc/ec.cu) is left for a
//     later change.
//   P3: one thread per lane; at the 2^16 lanes chip_smoke.py runs, the issue
//     rate of the multiply-adds bounds it.
// Elements live in local memory: the tower's helpers are __noinline__ and
// take references, so the compiler keeps one Fq2 multiply's words in
// registers at a time (a fully inlined Fq12 multiply would be 54 inlined
// products; field.cuh notes that inlining the Fq2 multiply alone once crashed
// the compiler). chip_smoke.py's build phase prints each kernel's registers,
// stack and spills.

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

constexpr int kPairThreads = 128;

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

__device__ __forceinline__ void f12_one(F12& r) {
  r.c0.c0 = A2::one();
  r.c0.c1 = A2::zero();
  r.c0.c2 = A2::zero();
  r.c1.c0 = A2::zero();
  r.c1.c1 = A2::zero();
  r.c1.c2 = A2::zero();
}

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
// kernels
// ---------------------------------------------------------------------------

// P1: one thread; per fold the square (if flagged), then each pair's line.
__global__ void __launch_bounds__(32, 1)
    pair_miller_loop_kernel(const int* __restrict__ flags, const u32* __restrict__ coeffs,
                            int n_folds, int n_pairs, u32* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  F12 acc;
  f12_one(acc);
#pragma unroll 1
  for (int f = 0; f < n_folds; f++) {
    if (flags[f]) f12_sq(acc, acc);
#pragma unroll 1
    for (int j = 0; j < n_pairs; j++) {
      const u32* c = coeffs + ((size_t)f * n_pairs + j) * 48;
      const F2 c0 = load_f2(c, 1, 0);
      const F2 c3 = load_f2(c + 16, 1, 0);
      const F2 c4 = load_f2(c + 32, 1, 0);
      f12_mul_by_034(acc, acc, c0, c3, c4);
    }
  }
  f12_store(out, 1, 0, acc);
}

// P2: one thread; the easy part, then the hard part over `bits` (0 or 1
// each), lowest first: result *= base where set, base squared between bits.
__global__ void __launch_bounds__(32, 1)
    pair_final_exp_kernel(const u32* __restrict__ f, const u32* __restrict__ frob,
                          const int* __restrict__ bits, int n_bits, u32* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  F12 a, t, u;
  f12_load(a, f, 1, 0);
  f12_conj(t, a);
  f12_inv(u, a);
  f12_mul(t, t, u);
  f12_frobenius(u, t, 2, frob);
  f12_mul(t, u, t);
  F12 result;
  f12_one(result);
#pragma unroll 1
  for (int i = 0; i < n_bits; i++) {
    if (bits[i]) f12_mul(result, result, t);
    if (i + 1 < n_bits) f12_sq(t, t);
  }
  f12_store(out, 1, 0, result);
}

enum F12Op { kMul = 0, kSq = 1, kInv = 2, kFrob = 3, kConj = 4, kMulBy034 = 5 };

// P3: one thread per lane. b: the second operand (96, n) for kMul, the
// line's (c0, c3, c4) as (48, n) for kMulBy034; unused otherwise.
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

}  // namespace kt

using namespace kt;

extern "C" int kt_pair_miller_loop(const void* flags, const void* coeffs, int n_folds, int n_pairs,
                                   void* out, void* stream) {
  pair_miller_loop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int*)flags, (const u32*)coeffs, n_folds, n_pairs, (u32*)out);
  return (int)cudaGetLastError();
}

extern "C" int kt_pair_final_exp(const void* f, const void* frob, const void* bits, int n_bits,
                                 void* out, void* stream) {
  pair_final_exp_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const u32*)f, (const u32*)frob, (const int*)bits, n_bits, (u32*)out);
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

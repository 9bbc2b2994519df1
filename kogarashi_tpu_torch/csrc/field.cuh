// 256-bit Montgomery field arithmetic for the port's CUDA kernels.
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
// Bound argument (every function returns a canonical value in [0, p)):
//   * p < 2^254 for both BN254 fields, so 2p < 2^255 and any sum of two
//     canonical values fits in 8 words with no carry out.
//   * mont_mul is CIOS (Koc et al.) over 32-bit words with 64-bit column
//     arithmetic. Every 64-bit step computes a*b + t + c with a, b, t, c
//     < 2^32, which is at most 2^64 - 1: no overflow. With a, b < p, the
//     running value after step i satisfies t < (2p + (2^32-1)p + (2^32-1)p)
//     / 2^32 < 2p, and before the shift t < 2p + 2^33 p < 2^288, so 9 words
//     hold it and the top word is 0 after the shift. One conditional
//     subtract of p then gives [0, p).
//   * add: a + b < 2p, one conditional subtract. sub: a - b, adding p back
//     when it borrows, lands in [0, p). neg(a) = sub(0, a), so 0 maps to 0.
// There are no lazily reduced values anywhere: the TPU engine's bounded
// "< 8p" bookkeeping (mont_pallas.py:20-34) is not needed, and its
// approximate predecessor's failure mode cannot arise.
//
// What bounds it on an H100: 32-bit integer multiply-add throughput (each
// 64-bit product is an IMAD.WIDE pair) and, for the Fq2 point formulas,
// registers. The code is straight-line after unrolling, so all limbs live in
// registers; constants fold into immediates. The 2^16-element field check
// kernel uses 42 registers (ptxas -v, CUDA 12.8, sm_90a).

#pragma once
#include <cstddef>
#include <cstdint>

namespace kt {

typedef uint32_t u32;
typedef uint64_t u64;

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

// r = t if t < p else t - p, for t < 2p.
template <class F>
__device__ __forceinline__ void cond_sub_p(u32* r, const u32* t) {
  u32 d[8];
  u32 borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 x = (u64)t[j] - F::p(j) - borrow;
    d[j] = (u32)x;
    borrow = (u32)(x >> 63);
  }
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = borrow ? t[j] : d[j];
}

template <class F>
__device__ __forceinline__ void fp_mul(u32* r, const u32* a, const u32* b) {
  u32 t[9];
#pragma unroll
  for (int j = 0; j < 9; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (u64)a[j] * b[i] + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    u64 s = (u64)t[8] + c;
    t[8] = (u32)s;  // s < 2^32: the running value is < 2^288
    u32 m = t[0] * F::inv;
    c = ((u64)m * F::p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (u64)m * F::p(j) + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    s = (u64)t[8] + c;
    t[7] = (u32)s;
    t[8] = (u32)(s >> 32);
  }
  cond_sub_p<F>(r, t);
}

template <class F>
__device__ __forceinline__ void fp_add(u32* r, const u32* a, const u32* b) {
  u32 t[8];
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    c += (u64)a[j] + b[j];
    t[j] = (u32)c;
    c >>= 32;
  }
  cond_sub_p<F>(r, t);
}

template <class F>
__device__ __forceinline__ void fp_sub(u32* r, const u32* a, const u32* b) {
  u32 t[8];
  u32 borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 x = (u64)a[j] - b[j] - borrow;
    t[j] = (u32)x;
    borrow = (u32)(x >> 63);
  }
  u32 mask = 0u - borrow;  // add p back only when a < b
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    c += (u64)t[j] + (F::p(j) & mask);
    r[j] = (u32)c;
    c >>= 32;
  }
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
  __device__ __forceinline__ static E load(const u32* __restrict__ a, size_t plane, size_t off) {
    E e;
#pragma unroll
    for (int k = 0; k < 8; k++) e.v[k] = a[k * plane + off];
    return e;
  }
  __device__ __forceinline__ static void store(u32* __restrict__ a, size_t plane, size_t off,
                                               const E& e) {
#pragma unroll
    for (int k = 0; k < 8; k++) a[k * plane + off] = e.v[k];
  }
};

// One base-field multiply as a call. The Fq2 point formulas would otherwise
// inline some forty 8x8-word products per add; with CUDA 12.8 that made
// cicc (the device front end) crash with a segmentation fault. Arguments go
// by value, so the call keeps them in registers (no stack frame, no spills).
template <class F>
__device__ __noinline__ Elem<8> fp_mul_call(Elem<8> a, Elem<8> b) {
  Elem<8> r;
  fp_mul<F>(r.v, a.v, b.v);
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
  __device__ __forceinline__ static E load(const u32* __restrict__ a, size_t plane, size_t off) {
    E e;
    e.c0 = B::load(a, plane, off);
    e.c1 = B::load(a + 8 * plane, plane, off);
    return e;
  }
  __device__ __forceinline__ static void store(u32* __restrict__ a, size_t plane, size_t off,
                                               const E& e) {
    B::store(a, plane, off, e.c0);
    B::store(a + 8 * plane, plane, off, e.c1);
  }
};

}  // namespace kt

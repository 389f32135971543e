// GF(2^255-19) and Edwards25519 point arithmetic for the MSM kernels.
//
// Device counterparts of the limb-major helpers of
// hotstuff_tpu/ops/pallas_msm.py (_carry_pass/_carry/_add/_sub/_mul at
// :59-93, _padd at :168-181, _neg_fe at :289-291), in the same
// radix-2^13 x 20-limb representation, so each kernel is limb-exact
// against its plain PyTorch version (hotstuff_tpu_torch/ops/field.py).
//
// Limbs hold int32 bit patterns in uint32: every add and multiply wraps
// mod 2^32 exactly as jnp/torch int32 arithmetic does (signed overflow would
// be undefined in C++), and the carry shift goes through int32 so it stays
// arithmetic, as `>>` is on jnp/torch int32. The 39 schoolbook columns of a
// product are < 2^31 for loose inputs, so uint32 accumulation is exact.
//
// What bounds these kernels on an H100: int32 multiply-adds. A field mul is
// 400 IMADs (20 x 20 limb products) plus ~200 shifts, masks and adds for the
// carries; a point add is 9 muls, a doubling 8. The kernels move a few
// hundred kilobytes, so memory is never the limit.
//
// Everything here is inlined and passed by value, so ptxas keeps a point's
// 80 words in registers; an out-of-line call with reference arguments put
// every point operation through the stack. These are one thread's helpers
// (sqrt_pow.cu, K2, K4); the warp-cooperative counterparts of K3, the
// decompression and the verdict are in fe25519_warp.cuh.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fe25519 {

constexpr int NLIMB = 20;
constexpr int RADIX = 13;
constexpr uint32_t MASK = (1u << RADIX) - 1;
constexpr uint32_t FOLD = 608;  // 2^260 = 19 * 2^5 (mod p)
constexpr int PT_WORDS = 4 * NLIMB;

struct Fe {
  uint32_t v[NLIMB];
};

// Extended coordinates (X : Y : Z : T), stored as [4][20] int32.
struct Pt {
  Fe x, y, z, t;
};

// 2d mod p in canonical limbs (ops/field.py D2_LIMBS).
static __constant__ uint32_t D2[NLIMB] = {
    4441, 5527, 1289, 3383, 3773, 6315, 2574, 4944, 20,  7,
    5196, 7655, 3886, 1856, 7270, 8092, 5855, 3810, 438, 72};

// d and sqrt(-1) mod p in canonical limbs (ops/field.py D_LIMBS,
// SQRT_M1_LIMBS), for decompression.
static __constant__ uint32_t D[NLIMB] = {
    6307, 6859, 4740, 5787, 5982, 3157, 1287, 2472, 4106, 3,
    6694, 3827, 1943, 928,  3635, 8142, 2927, 1905, 219,  164};
static __constant__ uint32_t SQRT_M1[NLIMB] = {
    176,  4213, 2514, 7222, 3150, 4668, 5311, 213,  792,  6522,
    5609, 7159, 2451, 1664, 3245, 7137, 4033, 1026, 201,  87};

// p and 2p in limbs (ops/field.py P_LIMBS, TWO_P_LIMBS).
__device__ __forceinline__ int32_t p_limb(int k) {
  return k == 0 ? 8173 : (k == NLIMB - 1 ? 255 : 8191);
}

__device__ __forceinline__ uint32_t two_p(int k) {
  return k == 0 ? 16346u : (k == NLIMB - 1 ? 510u : 16382u);
}

__device__ __forceinline__ uint32_t asr(uint32_t a, int bits = RADIX) {
  return static_cast<uint32_t>(static_cast<int32_t>(a) >> bits);
}

__device__ __forceinline__ void carry_pass(Fe& a) {
  uint32_t c[NLIMB];
#pragma unroll
  for (int k = 0; k < NLIMB; ++k) c[k] = asr(a.v[k]);
  a.v[0] = (a.v[0] & MASK) + c[NLIMB - 1] * FOLD;
#pragma unroll
  for (int k = 1; k < NLIMB; ++k) a.v[k] = (a.v[k] & MASK) + c[k - 1];
}

__device__ __forceinline__ void carry(Fe& a) {
  carry_pass(a);
  carry_pass(a);
  carry_pass(a);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NLIMB; ++k) r.v[k] = a.v[k] + b.v[k];
  carry(r);
  return r;
}

// a - b + 2p
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NLIMB; ++k) r.v[k] = a.v[k] + two_p(k) - b.v[k];
  carry(r);
  return r;
}

__device__ __forceinline__ Fe fe_neg(const Fe& a) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NLIMB; ++k) r.v[k] = two_p(k) - a.v[k];
  carry(r);
  return r;
}

// Schoolbook 20 x 20 -> 39 columns; one carry pass over the columns with
// the top carry as virtual column 39; fold columns >= 20 by 608; carry.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t cols[2 * NLIMB - 1];
#pragma unroll
  for (int k = 0; k < 2 * NLIMB - 1; ++k) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < NLIMB; ++i) {
#pragma unroll
    for (int j = 0; j < NLIMB; ++j) cols[i + j] += a.v[i] * b.v[j];
  }
  uint32_t c[2 * NLIMB - 1];
#pragma unroll
  for (int k = 0; k < 2 * NLIMB - 1; ++k) c[k] = asr(cols[k]);
#pragma unroll
  for (int k = 0; k < 2 * NLIMB - 1; ++k) cols[k] &= MASK;
#pragma unroll
  for (int k = 1; k < 2 * NLIMB - 1; ++k) cols[k] += c[k - 1];
  Fe r;
#pragma unroll
  for (int k = 0; k < NLIMB - 1; ++k) r.v[k] = cols[k] + cols[k + NLIMB] * FOLD;
  r.v[NLIMB - 1] = cols[NLIMB - 1] + c[2 * NLIMB - 2] * FOLD;
  carry(r);
  return r;
}

__device__ __forceinline__ Fe fe_load(const int32_t* src) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NLIMB; ++k) r.v[k] = static_cast<uint32_t>(src[k]);
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* dst, const Fe& a) {
#pragma unroll
  for (int k = 0; k < NLIMB; ++k) dst[k] = static_cast<int32_t>(a.v[k]);
}

__device__ __forceinline__ Pt pt_load(const int32_t* src) {
  return Pt{fe_load(src), fe_load(src + NLIMB), fe_load(src + 2 * NLIMB),
            fe_load(src + 3 * NLIMB)};
}

__device__ __forceinline__ void pt_store(int32_t* dst, const Pt& p) {
  fe_store(dst, p.x);
  fe_store(dst + NLIMB, p.y);
  fe_store(dst + 2 * NLIMB, p.z);
  fe_store(dst + 3 * NLIMB, p.t);
}

__device__ __forceinline__ Pt pt_identity() {
  Pt p;
#pragma unroll
  for (int k = 0; k < NLIMB; ++k) {
    p.x.v[k] = 0;
    p.y.v[k] = k == 0;
    p.z.v[k] = k == 0;
    p.t.v[k] = 0;
  }
  return p;
}

// Unified addition (add-2008-hwcd-3, a = -1), as _padd.
__device__ __forceinline__ Pt padd(const Pt& p, const Pt& q) {
  Fe d2;
#pragma unroll
  for (int k = 0; k < NLIMB; ++k) d2.v[k] = D2[k];
  const Fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  const Fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  const Fe c = fe_mul(fe_mul(p.t, d2), q.t);
  const Fe d = fe_mul(fe_add(p.z, p.z), q.z);
  const Fe e = fe_sub(b, a);
  const Fe f = fe_sub(d, c);
  const Fe g = fe_add(d, c);
  const Fe h = fe_add(b, a);
  return Pt{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

}  // namespace fe25519

// GF(2^255-19) and Edwards25519 point arithmetic on a whole warp, for K3,
// the decompression (decompress.cu) and the verdict (verdict.cu).
//
// The same radix-2^13 x 20-limb arithmetic as fe25519.cuh, and limb for
// limb the same results, with a field element spread over a warp: lane k
// (0..19) holds limb k. Lanes 20..31 mirror lanes 0..11 (`k` = lane - 20);
// they compute copies that nobody reads, so that every shuffle runs on the
// full warp. A field element is one register a lane and a point four.
//
// A product: lane k sums schoolbook columns k and k + 20 (k + 1 and 19 - k
// terms, 20 products for every lane), with a_i broadcast and b_{k-i mod 20}
// fetched by shuffles. Column sums mod 2^32 do not depend on the order of
// their terms, so they equal fe_mul's. The carry passes are fe_mul's
// parallel passes: every limb's carry comes from the values before the
// pass, so one shuffle from lane k - 1 (lane 19 for lane 0, times 608)
// gives each lane its carry-in. So every helper here equals its fe25519.cuh
// counterpart limb for limb.
//
// Why: a point operation on one thread is a chain of 8 or 9 field muls of
// ~700 instructions each. On a warp, a mul is 40 shuffles, 20 multiply-adds
// and 4 carry passes per lane, and the point operations below give the
// independent muls of a stage (the four squarings of a doubling, the four
// closing products) one warp each. That shortens the dependent chain of
// K3's Horner, which no reordering can remove.
#pragma once

#include "fe25519.cuh"

namespace fe25519_warp {

using fe25519::FOLD;
using fe25519::MASK;
using fe25519::NLIMB;

constexpr unsigned kFull = 0xffffffffu;

// Extended coordinates, lane k holding limb k of each.
struct WPt {
  uint32_t x, y, z, t;
};

// The limb this lane holds: lane for lanes 0..19, lane - 20 above.
__device__ __forceinline__ int limb_of_lane() {
  const int lane = threadIdx.x & 31;
  return lane < NLIMB ? lane : lane - NLIMB;
}

// The lane that holds limb k - 1 (limb 19 for k = 0).
__device__ __forceinline__ int prev_lane(int k) { return k == 0 ? NLIMB - 1 : k - 1; }

__device__ __forceinline__ uint32_t carry_pass(uint32_t r, int k) {
  const uint32_t cin = __shfl_sync(kFull, fe25519::asr(r), prev_lane(k));
  return (r & MASK) + (k == 0 ? cin * FOLD : cin);
}

__device__ __forceinline__ uint32_t carry(uint32_t r, int k) {
  return carry_pass(carry_pass(carry_pass(r, k), k), k);
}

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b, int k) {
  return carry(a + b, k);
}

// a - b + 2p
__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b, int k) {
  return carry(a + fe25519::two_p(k) - b, k);
}

__device__ __forceinline__ uint32_t neg(uint32_t a, int k) {
  return carry(fe25519::two_p(k) - a, k);
}

// Lanes 0..19 hold the limbs; lanes 20..31 hold copies.
__device__ __forceinline__ bool holds_limb() { return (threadIdx.x & 31) < NLIMB; }

// The fully reduced form in [0, p), as ops/field.py canonical: six carry
// passes, the bits at and above 2^255 folded back as *19 twice, then one
// conditional subtract of p with its borrow chain, comparing the int32
// limbs as torch compares them. The carries and folds run on every lane;
// a >= p is decided by two ballots (the top limb that differs from p's
// decides, and a equals p if none does); the subtract's borrow chain walks
// the limbs by broadcast, 20 shuffles. Every branch depends on ballots or
// broadcasts only, so the warp never diverges.
__device__ __forceinline__ uint32_t canonical(uint32_t a, int k) {
  a = carry(carry(a, k), k);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t hi = __shfl_sync(kFull, fe25519::asr(a, 8), NLIMB - 1);
    if (k == 0) a += hi * 19;
    if (k == NLIMB - 1) a &= 0xFF;
    a = carry(a, k);
  }
  const int32_t s = static_cast<int32_t>(a), pk = fe25519::p_limb(k);
  const unsigned gt = __ballot_sync(kFull, holds_limb() && s > pk);
  const unsigned ne = __ballot_sync(kFull, holds_limb() && s != pk);
  if (ne != 0 && !((gt >> (31 - __clz(static_cast<int>(ne)))) & 1u)) return a;  // a < p
  int32_t borrow = 0, out = 0;
#pragma unroll
  for (int j = 0; j < NLIMB; ++j) {
    const int32_t t = __shfl_sync(kFull, s - pk, j) - borrow;
    borrow = t < 0;
    if (j == k) out = t + (borrow << fe25519::RADIX);
  }
  return static_cast<uint32_t>(out);
}

// Every limb of a equals b's (both canonical); the same on every lane.
__device__ __forceinline__ bool all_equal(uint32_t a, uint32_t b) {
  return __ballot_sync(kFull, holds_limb() && a != b) == 0;
}

// ops/field.py eq and is_zero.
__device__ __forceinline__ bool eq(uint32_t a, uint32_t b, int k) {
  return all_equal(canonical(a, k), canonical(b, k));
}

__device__ __forceinline__ bool is_zero(uint32_t a, int k) { return all_equal(canonical(a, k), 0u); }

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b, int k) {
  // Column k takes a_i b_{k-i} for i <= k; column k + 20 takes a_i
  // b_{k+20-i} for i > k. Both are b_{(k - i) mod 20}.
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < NLIMB; ++i) {
    const uint32_t ai = __shfl_sync(kFull, a, i);
    const int j = k - i < 0 ? k - i + NLIMB : k - i;
    const uint32_t prod = ai * __shfl_sync(kFull, b, j);
    if (i <= k) {
      lo += prod;
    } else {
      hi += prod;
    }
  }
  // One carry pass over the 39 columns, top carry as virtual column 39:
  // column k takes column k - 1's carry (none for k = 0), column k + 20
  // takes column k + 19's, which lane k - 1 holds as its high column (lane
  // 19's low column for k = 0).
  const int src = prev_lane(k);
  const uint32_t c_lo = __shfl_sync(kFull, fe25519::asr(lo), src);
  const uint32_t c_hi = __shfl_sync(kFull, fe25519::asr(hi), src);
  lo = (lo & MASK) + (k == 0 ? 0u : c_lo);
  hi = (hi & MASK) + (k == 0 ? c_lo : c_hi);
  // Fold columns >= 20 by 608; limb 19 folds the virtual column 39, the
  // carry of column 38, which lane 18 holds.
  const uint32_t r = lo + (k == NLIMB - 1 ? c_hi : hi) * FOLD;
  return carry(r, k);
}

__device__ __forceinline__ WPt load(const int32_t* src, int k) {
  return WPt{static_cast<uint32_t>(src[k]), static_cast<uint32_t>(src[NLIMB + k]),
             static_cast<uint32_t>(src[2 * NLIMB + k]), static_cast<uint32_t>(src[3 * NLIMB + k])};
}

// Load through L2 only: for data another CTA wrote during this launch.
__device__ __forceinline__ WPt load_cg(const int32_t* src, int k) {
  return WPt{static_cast<uint32_t>(__ldcg(src + k)), static_cast<uint32_t>(__ldcg(src + NLIMB + k)),
             static_cast<uint32_t>(__ldcg(src + 2 * NLIMB + k)),
             static_cast<uint32_t>(__ldcg(src + 3 * NLIMB + k))};
}

// Lanes 0..19 of warp 0 store; the other lanes hold copies.
__device__ __forceinline__ void store(int32_t* dst, const WPt& p) {
  const int lane = threadIdx.x;
  if (lane < NLIMB) {
    dst[lane] = static_cast<int32_t>(p.x);
    dst[NLIMB + lane] = static_cast<int32_t>(p.y);
    dst[2 * NLIMB + lane] = static_cast<int32_t>(p.z);
    dst[3 * NLIMB + lane] = static_cast<int32_t>(p.t);
  }
}

// Point operations on the four warps of a CTA (kWarps x 32 threads). A
// stage's independent products run one on each warp, so on four of the
// SM's schedulers at once: warp j computes the stage's j-th product with
// the warp helpers above and posts it to shared memory; after a barrier
// every warp reads back all four, so every warp holds the whole point. The
// adds between stages are cheap and run on every warp. Stage 1 of an
// operation posts to xchg[0], stage 2 to xchg[1]; a warp reads a stage's
// results before it reaches the next stage's barrier, so two slots suffice.
constexpr int kWarps = 4;

struct Xchg {
  uint32_t v[2][kWarps][NLIMB];
};

__device__ __forceinline__ void post_and_sync(Xchg& x, int stage, uint32_t r) {
  const int lane = threadIdx.x & 31;
  if (lane < NLIMB) x.v[stage][threadIdx.x >> 5][lane] = r;
  __syncthreads();
}

// Unified addition, as fe25519::padd; d2 is this lane's limb of 2d.
// Stage 1: {(Y-X)(Y'-X'), (Y+X)(Y'+X'), (T 2d) T', 2Z Z'}, the third two
// products long; stage 2: {e f, g h, f g, e h}.
__device__ __forceinline__ WPt padd(const WPt& p, const WPt& q, uint32_t d2, int k, Xchg& x) {
  const int j = threadIdx.x >> 5;
  uint32_t r;
  if (j == 0) {
    r = mul(sub(p.y, p.x, k), sub(q.y, q.x, k), k);
  } else if (j == 1) {
    r = mul(add(p.y, p.x, k), add(q.y, q.x, k), k);
  } else if (j == 2) {
    r = mul(mul(p.t, d2, k), q.t, k);
  } else {
    r = mul(add(p.z, p.z, k), q.z, k);
  }
  post_and_sync(x, 0, r);
  const uint32_t a = x.v[0][0][k], b = x.v[0][1][k], c = x.v[0][2][k], d = x.v[0][3][k];
  const uint32_t e = sub(b, a, k);
  const uint32_t f = sub(d, c, k);
  const uint32_t g = add(d, c, k);
  const uint32_t h = add(b, a, k);
  post_and_sync(x, 1, mul(j == 0 || j == 3 ? e : (j == 1 ? g : f), j == 0 ? f : (j == 2 ? g : h), k));
  return WPt{x.v[1][0][k], x.v[1][1][k], x.v[1][2][k], x.v[1][3][k]};
}

// Dedicated doubling (dbl-2008-hwcd), as the reference's _pdouble.
// Stage 1: {X^2, Y^2, Z^2, (X+Y)^2}; stage 2: {e f, g h, f g, e h}.
__device__ __forceinline__ WPt pdouble(const WPt& p, int k, Xchg& x) {
  const int j = threadIdx.x >> 5;
  const uint32_t s = j == 0 ? p.x : (j == 1 ? p.y : (j == 2 ? p.z : add(p.x, p.y, k)));
  post_and_sync(x, 0, mul(s, s, k));
  const uint32_t a = x.v[0][0][k], b = x.v[0][1][k], zz = x.v[0][2][k], xy2 = x.v[0][3][k];
  const uint32_t c = add(zz, zz, k);
  const uint32_t h = add(a, b, k);
  const uint32_t e = sub(h, xy2, k);
  const uint32_t g = sub(a, b, k);
  const uint32_t f = add(c, g, k);
  post_and_sync(x, 1, mul(j == 0 || j == 3 ? e : (j == 1 ? g : f), j == 0 ? f : (j == 2 ? g : h), k));
  return WPt{x.v[1][0][k], x.v[1][1][k], x.v[1][2][k], x.v[1][3][k]};
}

}  // namespace fe25519_warp

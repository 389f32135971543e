// K1: the decompression root candidate r = u * v^3 * (u * v^7)^((p-5)/8).
//
// Replaces the Pallas kernel _sqrt_pow_kernel (hotstuff_tpu/ops/pallas_msm.py
// :233, addition chain _pow_p58 at :217), reached through sqrt_pow (:264).
// It reads and writes the [m, 20] int32 layout that sqrt_pow exposes, so the
// reference's [m, 20] <-> [20, m] transpose (:259) is gone.
//
// Bound on this card: int32 multiply-adds. Each lane runs 269 field muls
// (5 before the chain, 251 squarings and 11 muls in it, 2 after), i.e.
// 107,600 IMADs; the inputs and the output are 240 bytes a lane.
//
// Design: one thread per lane, the 20 limbs of every live value in
// registers, the addition chain unrolled except for the squaring runs,
// which loop. Lanes are independent, so nothing is shared between threads.
#include "fe25519.cuh"

using namespace fe25519;

namespace {

constexpr int kMaxThreads = 128;

// x^(2^k) by k squarings.
__device__ Fe sqk(Fe x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) x = fe_mul(x, x);
  return x;
}

// w^(2^252 - 3), the chain of _pow_p58.
__device__ Fe pow_p58(const Fe& w) {
  const Fe f1 = w;
  const Fe f2 = fe_mul(sqk(f1, 1), f1);
  const Fe f4 = fe_mul(sqk(f2, 2), f2);
  const Fe f5 = fe_mul(sqk(f4, 1), f1);
  const Fe f10 = fe_mul(sqk(f5, 5), f5);
  const Fe f20 = fe_mul(sqk(f10, 10), f10);
  const Fe f40 = fe_mul(sqk(f20, 20), f20);
  const Fe f80 = fe_mul(sqk(f40, 40), f40);
  const Fe f160 = fe_mul(sqk(f80, 80), f80);
  const Fe f240 = fe_mul(sqk(f160, 80), f80);
  const Fe f250 = fe_mul(sqk(f240, 10), f10);
  return fe_mul(sqk(f250, 2), w);
}

__global__ void __launch_bounds__(kMaxThreads)
    sqrt_pow_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
                    int32_t* __restrict__ r, int m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= m) return;
  const Fe uu = fe_load(u + static_cast<size_t>(lane) * NLIMB);
  const Fe vv = fe_load(v + static_cast<size_t>(lane) * NLIMB);
  const Fe v2 = fe_mul(vv, vv);
  const Fe v3 = fe_mul(v2, vv);
  const Fe v7 = fe_mul(fe_mul(v3, v3), vv);
  const Fe w = fe_mul(uu, v7);
  fe_store(r + static_cast<size_t>(lane) * NLIMB, fe_mul(fe_mul(uu, v3), pow_p58(w)));
}

}  // namespace

// u, v, r: int32 [m, 20], contiguous, on the stream's device; `threads`
// lanes per CTA, 1 .. 128.
extern "C" int sqrt_pow_launch(const void* u, const void* v, void* r, int m, int threads,
                               void* stream) {
  if (m <= 0 || threads < 1 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (m + threads - 1) / threads;
  sqrt_pow_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(u), static_cast<const int32_t*>(v),
      static_cast<int32_t*>(r), m);
  return static_cast<int>(cudaGetLastError());
}

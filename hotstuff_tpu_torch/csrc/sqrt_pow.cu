// K1: the decompression root candidate r = u * v^3 * (u * v^7)^((p-5)/8).
//
// Replaces the Pallas kernel _sqrt_pow_kernel (hotstuff_tpu/ops/pallas_msm.py
// :233, addition chain _pow_p58 at :217), reached through sqrt_pow (:264).
// It reads and writes the [m, 20] int32 layout that sqrt_pow exposes, so the
// reference's [m, 20] <-> [20, m] transpose (:259) is gone. The QC path
// decompresses with decompress.cu, which runs the same chain inside it; this
// root-only kernel stays as the counterpart of the reference's sqrt_pow.
//
// Bound on this card: int32 multiply-adds. Each lane runs 269 field muls
// (5 before the chain, 251 squarings and 11 muls in it, 2 after), i.e.
// 107,600 IMADs; the inputs and the output are 240 bytes a lane.
//
// Design: one thread per lane, the 20 limbs of every live value in
// registers, the addition chain (pow_p58.cuh) unrolled except for the
// squaring runs, which loop. Lanes are independent, so nothing is shared
// between threads.
#include "fe25519.cuh"
#include "pow_p58.cuh"

using namespace fe25519;

namespace {

constexpr int kMaxThreads = 128;

struct ThreadField {
  __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) const { return fe_mul(a, b); }
};

__global__ void __launch_bounds__(kMaxThreads)
    sqrt_pow_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
                    int32_t* __restrict__ r, int m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= m) return;
  const Fe uu = fe_load(u + static_cast<size_t>(lane) * NLIMB);
  const Fe vv = fe_load(v + static_cast<size_t>(lane) * NLIMB);
  fe_store(r + static_cast<size_t>(lane) * NLIMB, pow_p58::root_candidate(ThreadField{}, uu, vv));
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

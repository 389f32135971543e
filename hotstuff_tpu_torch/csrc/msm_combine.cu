// K3: combine per-block window partials and run Horner over the windows.
//
// Replaces the Pallas kernel _make_combine_kernel (hotstuff_tpu/ops/
// pallas_msm.py:436), which serves both MSMs (_build_signed :562 and
// _build_combine :495).
//
// Input: partials int32 [n_blocks, n_windows, 4, 20] from K2 or K4.
// Output: one point int32 [4, 20]:
//   W[w] = sum_g partials[g, w]   (g in order, as the reference),
//   S = W[0]; S = 16 * S + W[w] for w = 1 .. n_windows - 1 (MSB-first).
//
// Bound on this card: int32 multiply-adds. Work: n_windows * (n_blocks - 1)
// point adds, then (n_windows - 1) * (4 doublings + 1 add).
//
// Design: one CTA of n_windows threads. Thread w sums window w across the
// blocks (windows in parallel); the Horner chain is inherently serial and
// runs on thread 0 from shared memory. That chain of dependent point ops
// (4 doublings + 1 add per window) is the kernel's critical path: in this
// simple design one thread's latency, not the card's IMAD rate, sets its
// time. Splitting each field mul across a warp would shorten it.
#include "fe25519.cuh"

using namespace fe25519;

namespace {

constexpr int kMaxWindows = 64;

__global__ void __launch_bounds__(kMaxWindows)
    msm_combine_kernel(const int32_t* __restrict__ partials, int32_t* __restrict__ out,
                       int n_blocks, int n_windows) {
  __shared__ Pt sums[kMaxWindows];
  const int w = threadIdx.x;
  if (w < n_windows) {
    Pt cur = pt_load(partials + static_cast<size_t>(w) * PT_WORDS);
    for (int g = 1; g < n_blocks; ++g) {
      const Pt q = pt_load(partials + (static_cast<size_t>(g) * n_windows + w) * PT_WORDS);
      padd(cur, cur, q);
    }
    sums[w] = cur;
  }
  __syncthreads();
  if (w == 0) {
    Pt s = sums[0];
    for (int i = 1; i < n_windows; ++i) {
      pdouble(s, s);
      pdouble(s, s);
      pdouble(s, s);
      pdouble(s, s);
      padd(s, s, sums[i]);
    }
    pt_store(out, s);
  }
}

}  // namespace

extern "C" int msm_combine_launch(const void* partials, void* out, int n_blocks, int n_windows,
                                  void* stream) {
  if (n_blocks < 1 || n_windows < 1 || n_windows > kMaxWindows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  msm_combine_kernel<<<1, kMaxWindows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(partials), static_cast<int32_t*>(out), n_blocks, n_windows);
  return static_cast<int>(cudaGetLastError());
}

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
// Bound on this card: the work is n_windows * (n_blocks - 1) point adds,
// then (n_windows - 1) * (4 doublings + 1 add), a few microseconds of the
// card's int32 multiply-adds. What sets the time is the chain: the block
// sums of a window are n_blocks - 1 dependent adds, and the Horner is
// 4 (n_windows - 1) doublings and n_windows - 1 adds, each depending on the
// last (at 64 windows 315 point ops, about 2,583 dependent field muls). Any
// order of the combine keeps the top window's 252 doublings on the path.
//
// Design: shorten each dependent point op by running it on a CTA of four
// warps (fe25519_warp.cuh): lane k of a warp holds limb k, a field mul is
// 20 multiply-adds and ~45 shuffles a lane, and the independent muls of a
// stage run one on each warp, i.e. on four schedulers. The block sums go
// over the SMs: CTA w sums window w over the blocks and writes it to
// `sums`; the last CTA to finish (a ticket counter, zeroed by the caller)
// runs the Horner from `sums`. Every sum and the Horner keep the
// reference's order, so the result is limb-exact.
#include "fe25519_warp.cuh"

namespace fw = fe25519_warp;

namespace {

constexpr int kMaxWindows = 64;
constexpr int kThreads = fw::kWarps * 32;

__global__ void __launch_bounds__(kThreads)
    msm_combine_kernel(const int32_t* __restrict__ partials, int32_t* __restrict__ out,
                       int32_t* __restrict__ sums, unsigned* __restrict__ ticket,
                       int n_blocks, int n_windows) {
  __shared__ fw::Xchg xchg;
  __shared__ bool last;
  const int k = fw::limb_of_lane();
  const uint32_t d2 = fe25519::D2[k];
  const int w = blockIdx.x;
  using fe25519::PT_WORDS;

  fw::WPt cur = fw::load(partials + static_cast<size_t>(w) * PT_WORDS, k);
#pragma unroll 1
  for (int g = 1; g < n_blocks; ++g) {
    const fw::WPt q = fw::load(partials + (static_cast<size_t>(g) * n_windows + w) * PT_WORDS, k);
    cur = fw::padd(cur, q, d2, k, xchg);
  }
  fw::store(sums + static_cast<size_t>(w) * PT_WORDS, cur);

  // The storing lanes' writes are visible on the device before thread 0
  // takes a ticket; the CTA that takes the last one sees every window's sum.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == static_cast<unsigned>(n_windows - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  fw::WPt s = fw::load_cg(sums, k);
#pragma unroll 1
  for (int i = 1; i < n_windows; ++i) {
    s = fw::pdouble(s, k, xchg);
    s = fw::pdouble(s, k, xchg);
    s = fw::pdouble(s, k, xchg);
    s = fw::pdouble(s, k, xchg);
    s = fw::padd(s, fw::load_cg(sums + static_cast<size_t>(i) * PT_WORDS, k), d2, k, xchg);
  }
  fw::store(out, s);
}

}  // namespace

// partials int32 [n_blocks, n_windows, 4, 20] and out int32 [4, 20],
// contiguous on the stream's device; sums int32 [n_windows, 4, 20] scratch;
// ticket one uint32 that is 0 at launch.
extern "C" int msm_combine_launch(const void* partials, void* out, void* sums, void* ticket,
                                  int n_blocks, int n_windows, void* stream) {
  if (n_blocks < 1 || n_windows < 1 || n_windows > kMaxWindows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  msm_combine_kernel<<<n_windows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(partials), static_cast<int32_t*>(out),
      static_cast<int32_t*>(sums), static_cast<unsigned*>(ticket), n_blocks, n_windows);
  return static_cast<int>(cudaGetLastError());
}

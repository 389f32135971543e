// K2 / K4: per-block window partial sums of a radix-16 MSM.
//
// Replaces two Pallas kernels of hotstuff_tpu/ops/pallas_msm.py:
//   - _make_partials_kernel_signed (:294), signed digits in [-8, 8], a
//     9-entry table and a conditional negate (K2, both MSMs of a cached QC);
//   - _partials_kernel (:385), unsigned digits in 0..15 and a 16-entry
//     table, 64 windows (K4, the uncached fallback).
// One template covers both. The TPU's 16-lane TAIL staging (:278-286) is a
// vreg-width device and is not carried over.
//
// Input: points int32 [m, 4, 20], digits int32 [n_windows, m] MSB-first.
// Output: partials int32 [m / block, n_windows, 4, 20]; entry (g, w) is the
// sum over the block's lanes j of digit[w, j] * P_j. The MSM combine (K3)
// reduces across blocks and runs Horner.
//
// Bound on this card: int32 multiply-adds (400 per field mul, 9 muls per
// point add). Work: (table - 2) adds a lane for the table, then block - 1
// adds per block and window for the reduction.
//
// Design: one thread per lane and one CTA per lane block. Each thread builds
// its table in local memory (9 or 16 entries x 320 bytes) and per window
// selects its multiple; the CTA then tree-reduces its points through shared
// memory, pairing lane t with lane t + half as the reference's tree does.
// CTAs carry nothing between them, so the cross-block sum belongs to K3.
// Each window's tree is log2(block) dependent point adds per thread, and a
// batch of m lanes runs m / block CTAs: at the main path's widths most SMs
// idle, so latency, not the IMAD rate, sets the time of this first design.
#include "fe25519.cuh"

using namespace fe25519;

namespace {

constexpr int kMaxBlock = 128;
constexpr int kMaxWindows = 64;

template <bool kSigned>
__global__ void __launch_bounds__(kMaxBlock)
    msm_partials_kernel(const int32_t* __restrict__ points,
                        const int32_t* __restrict__ digits,
                        int32_t* __restrict__ partials, int m, int n_windows) {
  constexpr int kTable = kSigned ? 9 : 16;
  extern __shared__ Pt red[];  // blockDim.x points
  const int t = threadIdx.x;
  const int lane = blockIdx.x * blockDim.x + t;

  Pt table[kTable];
  table[0] = pt_identity();
  table[1] = pt_load(points + static_cast<size_t>(lane) * PT_WORDS);
  for (int d = 2; d < kTable; ++d) padd(table[d], table[d - 1], table[1]);

  for (int w = 0; w < n_windows; ++w) {
    const int dg = digits[static_cast<size_t>(w) * m + lane];
    Pt sel;
    if (kSigned) {
      // The host recoder keeps |dg| <= 8; the clamp only keeps a bad digit
      // inside the table.
      const int mag = min(dg < 0 ? -dg : dg, kTable - 1);
      sel = table[mag];
      if (dg < 0) {
        sel.x = fe_neg(sel.x);
        sel.t = fe_neg(sel.t);
      }
    } else {
      sel = table[dg & (kTable - 1)];
    }
    // Level `half` reads slots [half, 2 half) and writes [0, half): one
    // barrier per level suffices.
    red[t] = sel;
    __syncthreads();
    for (int half = blockDim.x / 2; half >= 1; half >>= 1) {
      if (t < half) {
        padd(sel, sel, red[t + half]);
        red[t] = sel;
      }
      __syncthreads();
    }
    if (t == 0) {
      pt_store(partials + (static_cast<size_t>(blockIdx.x) * n_windows + w) * PT_WORDS, sel);
    }
  }
}

template <bool kSigned>
int launch(const void* points, const void* digits, void* partials, int m, int n_windows,
           int block, void* stream) {
  if (block < 1 || block > kMaxBlock || (block & (block - 1)) || m < block || m % block ||
      n_windows < 1 || n_windows > kMaxWindows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  msm_partials_kernel<kSigned>
      <<<m / block, block, block * sizeof(Pt), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(points), static_cast<const int32_t*>(digits),
          static_cast<int32_t*>(partials), m, n_windows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int msm_partials_signed_launch(const void* points, const void* digits,
                                          void* partials, int m, int n_windows, int block,
                                          void* stream) {
  return launch<true>(points, digits, partials, m, n_windows, block, stream);
}

extern "C" int msm_partials_unsigned_launch(const void* points, const void* digits,
                                            void* partials, int m, int n_windows, int block,
                                            void* stream) {
  return launch<false>(points, digits, partials, m, n_windows, block, stream);
}

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
// adds per block and window for the reduction. At the main path's widths
// (m = 1024, block 64) that work is far too small to fill the card, so what
// sets the time is the chain of dependent point adds each thread runs and
// how many SMs run such chains side by side.
//
// Design: one thread per lane; a CTA takes one lane block and a group of
// `group` consecutive windows (grid m / block x ceil(n_windows / group)), so
// the windows of a block spread over CTAs and SMs instead of running one
// after another in one CTA. Each thread builds its lane's table (in local
// memory: it is indexed by the digit) and per window selects its multiple;
// the CTA then tree-reduces the block, pairing lane t with lane t + half as
// the reference's tree does. Levels that cross warps go through shared
// memory, one barrier a level; the last five levels run in warp 0 with
// shuffles. The point arithmetic is inlined (fe25519.cuh), so the chain's
// points stay in registers. Each thread's chain is table - 2 + group *
// log2(block) point adds (19 for K2 at the wrapper's group of 2), against
// table - 2 + n_windows * log2(block) (391 at 64 windows) when one CTA ran
// every window.
//
// Why every CTA rebuilds its lanes' table instead of loading it: a pass
// that wrote the tables to device memory (9 x 320 bytes a lane, 2.9 MB at
// m = 1024, so it would stay in L2) would still be a chain of 7 dependent
// adds a lane, on a launch of its own that the window CTAs wait for: it
// would take the 7 adds out of this kernel's chain of 19 but put them in
// front of it, on far fewer threads. So the simpler rebuild stays (the
// other way was not built). The table is deterministic, so every CTA of a
// block gets the same limbs.
#include "fe25519.cuh"

using namespace fe25519;

namespace {

constexpr int kMaxBlock = 128;
constexpr int kMaxWindows = 64;
constexpr int kWarp = 32;

__device__ __forceinline__ Pt shfl_down(const Pt& p, int delta, unsigned mask) {
  Pt r;
#pragma unroll
  for (int k = 0; k < NLIMB; ++k) {
    r.x.v[k] = __shfl_down_sync(mask, p.x.v[k], delta);
    r.y.v[k] = __shfl_down_sync(mask, p.y.v[k], delta);
    r.z.v[k] = __shfl_down_sync(mask, p.z.v[k], delta);
    r.t.v[k] = __shfl_down_sync(mask, p.t.v[k], delta);
  }
  return r;
}

template <bool kSigned>
__global__ void __launch_bounds__(kMaxBlock)
    msm_partials_kernel(const int32_t* __restrict__ points,
                        const int32_t* __restrict__ digits,
                        int32_t* __restrict__ partials, int m, int n_windows, int group) {
  constexpr int kTable = kSigned ? 9 : 16;
  extern __shared__ Pt red[];  // blockDim.x points
  const int t = threadIdx.x;
  const int lane = blockIdx.x * blockDim.x + t;
  const int w_begin = blockIdx.y * group;
  const int w_end = min(w_begin + group, n_windows);

  Pt table[kTable];
  table[0] = pt_identity();
  table[1] = pt_load(points + static_cast<size_t>(lane) * PT_WORDS);
#pragma unroll 1
  for (int d = 2; d < kTable; ++d) table[d] = padd(table[d - 1], table[1]);

#pragma unroll 1
  for (int w = w_begin; w < w_end; ++w) {
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
    int half = blockDim.x / 2;
    if (half >= kWarp) {
      // Level `half` reads slots [half, 2 half) and writes [0, half): one
      // barrier per level suffices. The next window's first write comes
      // after every read of this one, behind the last level's barrier.
      red[t] = sel;
      __syncthreads();
#pragma unroll 1
      for (; half >= kWarp; half >>= 1) {
        if (t < half) {
          sel = padd(sel, red[t + half]);
          red[t] = sel;
        }
        __syncthreads();
      }
    }
    if (t < kWarp) {
      // Lanes t >= half add values no one reads; lane t < half pairs with
      // lane t + half < 2 half <= blockDim.x, which holds its last level's
      // sum.
      const unsigned mask = blockDim.x >= kWarp ? 0xffffffffu : (1u << blockDim.x) - 1u;
#pragma unroll 1
      for (; half >= 1; half >>= 1) sel = padd(sel, shfl_down(sel, half, mask));
      if (t == 0) {
        pt_store(partials + (static_cast<size_t>(blockIdx.x) * n_windows + w) * PT_WORDS, sel);
      }
    }
  }
}

template <bool kSigned>
int launch(const void* points, const void* digits, void* partials, int m, int n_windows,
           int block, int group, void* stream) {
  if (block < 1 || block > kMaxBlock || (block & (block - 1)) || m < block || m % block ||
      n_windows < 1 || n_windows > kMaxWindows || group < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(m / block, (n_windows + group - 1) / group);
  msm_partials_kernel<kSigned>
      <<<grid, block, block * sizeof(Pt), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(points), static_cast<const int32_t*>(digits),
          static_cast<int32_t*>(partials), m, n_windows, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// points int32 [m, 4, 20], digits int32 [n_windows, m], partials int32
// [m / block, n_windows, 4, 20], all contiguous on the stream's device;
// `block` a power of two up to 128 dividing m; `group` windows per CTA.
extern "C" int msm_partials_signed_launch(const void* points, const void* digits,
                                          void* partials, int m, int n_windows, int block,
                                          int group, void* stream) {
  return launch<true>(points, digits, partials, m, n_windows, block, group, stream);
}

extern "C" int msm_partials_unsigned_launch(const void* points, const void* digits,
                                            void* partials, int m, int n_windows, int block,
                                            int group, void* stream) {
  return launch<false>(points, digits, partials, m, n_windows, block, group, stream);
}

// The verdict of a batch: all(ok) and 8 (a + b) == O.
//
// No Pallas kernel has this job: in the reference it is jnp code that XLA
// fuses on a TPU (hotstuff_tpu/ops/verify.py:109 and :353, with
// curve.py:104 is_identity and :290 mul_by_cofactor). The port ran it as
// plain torch code on one point, some 3,200 small ops a QC, each its own
// launch; this kernel runs it in one. The cached path passes both MSM
// results (a + b first, add-2008-hwcd-3), the uncached path one (b null).
//
// Bound on this card: the work is one point add and three doublings (33
// field muls) and a read of m bytes of ok, a few nanoseconds of the card's
// int32 rate or bandwidth. What sets the time is the chain of dependent
// mul stages (3 for the add, 2 per doubling) and the launch itself.
//
// Design: one CTA of four warps. The ok flags reduce by __syncthreads_and;
// the point ops are fe25519_warp.cuh's staged ones (a stage's independent
// muls one per warp); the identity check (x == 0 and y == z, each side
// canonical) runs by ballots on the warp. Every step is the plain version's,
// so the bool is the same.
#include "fe25519_warp.cuh"

namespace fw = fe25519_warp;

namespace {

constexpr int kThreads = fw::kWarps * 32;

__global__ void __launch_bounds__(kThreads)
    verdict_kernel(const uint8_t* __restrict__ ok, int m, const int32_t* __restrict__ a,
                   const int32_t* __restrict__ b, uint8_t* __restrict__ out) {
  __shared__ fw::Xchg xchg;
  int all = 1;
  for (int i = threadIdx.x; i < m; i += kThreads) all &= ok[i] != 0;
  all = __syncthreads_and(all);

  const int k = fw::limb_of_lane();
  fw::WPt s = fw::load(a, k);
  if (b != nullptr) s = fw::padd(s, fw::load(b, k), fe25519::D2[k], k, xchg);
  s = fw::pdouble(s, k, xchg);
  s = fw::pdouble(s, k, xchg);
  s = fw::pdouble(s, k, xchg);
  const bool x_zero = fw::is_zero(s.x, k);
  const bool y_is_z = fw::eq(s.y, s.z, k);
  if (threadIdx.x == 0) *out = all && x_zero && y_is_z;
}

}  // namespace

// ok bool [m] (m >= 0), a and b int32 [4, 20] (b may be null), out one
// bool; contiguous on the stream's device.
extern "C" int verdict_launch(const void* ok, int m, const void* a, const void* b, void* out,
                              void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  verdict_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ok), m, static_cast<const int32_t*>(a),
      static_cast<const int32_t*>(b), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

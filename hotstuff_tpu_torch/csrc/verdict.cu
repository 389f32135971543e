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
//
// verdict_tree_kernel is the sharded verifier's verdict (parallel/mesh.py):
// the reference gathers the shards' [4, 20] MSM results and adds them by a
// halving tree (hotstuff_tpu/parallel/mesh.py:55-64), then checks the sum
// as above. Here the shards' results arrive on one card as [d, 4, 20] and
// one CTA adds them: s_i = a_i + b_i, then s[:half] + s[half:2 half] a
// level, the reference's order at a power-of-two d. At an odd width the
// last point is carried into the next level; the reference's tree drops
// it, so its verdict rejects a valid batch at d = 3 or 6. The level's
// points live in shared memory (d <= kMaxShards, 320 B each); every point
// op is the staged one of verdict_kernel. As there, the work is a few
// nanoseconds of the card's int32 rate: what sets the time is the chain of
// dependent mul stages (3 a point add, d - 1 adds, d more with b, then the
// doublings) and, at small d, the launch.
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

constexpr int kMaxShards = 64;
constexpr int kPoint = 4 * fw::NLIMB;

__global__ void __launch_bounds__(kThreads)
    verdict_tree_kernel(const uint8_t* __restrict__ ok, int m, const int32_t* __restrict__ a,
                        const int32_t* __restrict__ b, int d, uint8_t* __restrict__ out,
                        int32_t* __restrict__ out_point) {
  __shared__ fw::Xchg xchg;
  __shared__ int32_t level[kMaxShards * kPoint];
  const int k = fw::limb_of_lane();
  // Level 0: the shards' sums. Warp 0 stores (fw::store); the barrier
  // inside padd orders every warp's loads before that store.
  for (int i = 0; i < d; ++i) {
    fw::WPt s = fw::load(a + i * kPoint, k);
    if (b != nullptr) s = fw::padd(s, fw::load(b + i * kPoint, k), fe25519::D2[k], k, xchg);
    fw::store(level + i * kPoint, s);
  }
  __syncthreads();
  // A level writes s[i] for i < half and reads s[i'] and s[i' + half] for
  // i' >= i only, so it runs in place; the carried point moves to s[half]
  // after s[half] was read.
  for (int n = d; n > 1;) {
    const int half = n >> 1;
    for (int i = 0; i < half; ++i) {
      const fw::WPt p = fw::load(level + i * kPoint, k);
      const fw::WPt q = fw::load(level + (i + half) * kPoint, k);
      fw::store(level + i * kPoint, fw::padd(p, q, fe25519::D2[k], k, xchg));
    }
    if (n & 1) fw::store(level + half * kPoint, fw::load(level + (n - 1) * kPoint, k));
    n = half + (n & 1);
    __syncthreads();
  }
  fw::WPt s = fw::load(level, k);
  if (out_point != nullptr) fw::store(out_point, s);
  if (out == nullptr) return;

  int all = 1;
  for (int i = threadIdx.x; i < m; i += kThreads) all &= ok[i] != 0;
  all = __syncthreads_and(all);
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

// ok bool [m] (m >= 0; unread without out), a and b int32 [d, 4, 20] (b may
// be null), 1 <= d <= 64; out one bool and out_point int32 [4, 20], either
// null (out null: the combined point alone, as msm_sharded asks);
// contiguous on the stream's device.
extern "C" int verdict_tree_launch(const void* ok, int m, const void* a, const void* b, int d,
                                   void* out, void* out_point, void* stream) {
  if (m < 0 || d < 1 || d > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  verdict_tree_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ok), m, static_cast<const int32_t*>(a),
      static_cast<const int32_t*>(b), d, static_cast<uint8_t*>(out),
      static_cast<int32_t*>(out_point));
  return static_cast<int>(cudaGetLastError());
}

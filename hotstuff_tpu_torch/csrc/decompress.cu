// K1, redesigned: the whole batch point decompression in one kernel.
//
// Replaces the Pallas kernel _sqrt_pow_kernel (hotstuff_tpu/ops/
// pallas_msm.py:233, built at :248) together with the jnp code around it
// in the reference's decompress (hotstuff_tpu/ops/curve.py:109: sqrt_ratio
// and canonical in ops/field.py:258, :201), which on a TPU XLA fuses around
// the kernel. Input: y limbs int32 [m, 20] and signs int32 [m]. Output: ok
// (bool [m]) and the extended point (x, y, 1, x y) int32 [m, 4, 20], limb
// for limb as ops/curve.py decompress with root_fn=sqrt_pow_plain:
//   u = y^2 - 1, v = d y^2 + 1; r = u v^3 (u v^7)^((p-5)/8) (pow_p58.cuh);
//   check = r^2 v; correct = eq(check, u); flipped = eq(check, -u);
//   r *= sqrt(-1) where flipped; x = canonical(r); x = -x where
//   x_0 & 1 != sign; ok = (correct | flipped) & !(x == 0 & sign == 1).
// Lanes that fail write their point all the same, as the plain version.
//
// Bound on this card: int32 multiply-adds, 274 or 275 field muls a lane
// (2 for u and v, 269 in the root, 2 for the check, 1 for sqrt(-1) where
// flipped, 1 for x y) at 400 IMADs each; 405 bytes a lane in and out.
//
// What sets the time is the chain: every mul of a lane depends on the one
// before. On one thread (as in sqrt_pow.cu) a mul with its carries is some
// 700 int32 instructions, issued at about half a warp-instruction a cycle
// on a scheduler, so the chain is about 0.19 ms however the lanes are
// spread. Here each lane is one warp, with fe25519_warp.cuh's arithmetic
// (lane k holds limb k): a mul is 20 multiply-adds, ~46 shuffles and the
// carry passes a thread, so the chain is some 8x shorter in instructions,
// and 1024 lanes make 1024 warps, two for each of the card's schedulers.
// canonical, eq and is_zero run on the warp by ballots and broadcasts.
#include "fe25519_warp.cuh"
#include "pow_p58.cuh"

namespace fw = fe25519_warp;
using fe25519::NLIMB;

namespace {

constexpr int kWarpsPerCta = 4;

struct WarpField {
  int k;
  __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) const { return fw::mul(a, b, k); }
};

__global__ void __launch_bounds__(kWarpsPerCta * 32)
    decompress_kernel(const int32_t* __restrict__ y, const int32_t* __restrict__ sign,
                           bool* __restrict__ ok, int32_t* __restrict__ out, int m) {
  const int lane = blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (lane >= m) return;  // the whole warp
  const int k = fw::limb_of_lane();
  const WarpField f{k};
  const uint32_t yk = static_cast<uint32_t>(y[static_cast<size_t>(lane) * NLIMB + k]);
  const int32_t s = sign[lane];
  const uint32_t one = k == 0;

  const uint32_t yy = f.mul(yk, yk);
  const uint32_t u = fw::sub(yy, one, k);
  const uint32_t v = fw::add(f.mul(yy, fe25519::D[k]), one, k);
  uint32_t r = pow_p58::root_candidate(f, u, v);

  const uint32_t check = fw::canonical(f.mul(f.mul(r, r), v), k);
  const bool correct = fw::all_equal(check, fw::canonical(u, k));
  const bool flipped = fw::all_equal(check, fw::canonical(fw::neg(u, k), k));
  if (flipped) r = f.mul(r, fe25519::SQRT_M1[k]);
  uint32_t x = fw::canonical(r, k);
  const int32_t parity = static_cast<int32_t>(__shfl_sync(fw::kFull, x, 0) & 1u);
  if (parity != s) x = fw::neg(x, k);
  const bool x_zero = fw::is_zero(x, k);
  const bool good = (correct || flipped) && !(x_zero && s == 1);
  const uint32_t t = f.mul(x, yk);

  if (fw::holds_limb()) {
    int32_t* dst = out + static_cast<size_t>(lane) * fe25519::PT_WORDS;
    dst[k] = static_cast<int32_t>(x);
    dst[NLIMB + k] = static_cast<int32_t>(yk);
    dst[2 * NLIMB + k] = static_cast<int32_t>(one);
    dst[3 * NLIMB + k] = static_cast<int32_t>(t);
    if (k == 0) ok[lane] = good;
  }
}

}  // namespace

// y int32 [m, 20], sign int32 [m], ok bool [m], out int32 [m, 4, 20], all
// contiguous on the stream's device.
extern "C" int decompress_launch(const void* y, const void* sign, void* ok, void* out, int m,
                                 void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (m + kWarpsPerCta - 1) / kWarpsPerCta;
  decompress_kernel<<<blocks, kWarpsPerCta * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(y), static_cast<const int32_t*>(sign), static_cast<bool*>(ok),
      static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

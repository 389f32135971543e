// The decompression root candidate r = u * v^3 * (u * v^7)^((p-5)/8), with
// the addition chain of the reference's _pow_p58 (hotstuff_tpu/ops/
// pallas_msm.py:217) for w^((p-5)/8) = w^(2^252 - 3): 269 field muls.
//
// Written once for any field representation `F`, a struct whose
// `mul(a, b)` multiplies two elements of type `T`: K1 (sqrt_pow.cu, one
// thread a lane, fe25519.cuh) and the decompression kernel (decompress.cu,
// one thread or one warp a lane) run the same chain, so their roots agree
// limb for limb with sqrt_pow_plain in ops/msm_kernels.py.
#pragma once

namespace pow_p58 {

// x^(2^k) by k squarings.
template <class F, class T>
__device__ __forceinline__ T sqk(const F& f, T x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) x = f.mul(x, x);
  return x;
}

// w^(2^252 - 3).
template <class F, class T>
__device__ __forceinline__ T pow_p58(const F& f, const T& w) {
  const T f1 = w;
  const T f2 = f.mul(sqk(f, f1, 1), f1);
  const T f4 = f.mul(sqk(f, f2, 2), f2);
  const T f5 = f.mul(sqk(f, f4, 1), f1);
  const T f10 = f.mul(sqk(f, f5, 5), f5);
  const T f20 = f.mul(sqk(f, f10, 10), f10);
  const T f40 = f.mul(sqk(f, f20, 20), f20);
  const T f80 = f.mul(sqk(f, f40, 40), f40);
  const T f160 = f.mul(sqk(f, f80, 80), f80);
  const T f240 = f.mul(sqk(f, f160, 80), f80);
  const T f250 = f.mul(sqk(f, f240, 10), f10);
  return f.mul(sqk(f, f250, 2), w);
}

// u * v^3 * (u v^7)^((p-5)/8), step by step as _sqrt_pow_kernel.
template <class F, class T>
__device__ __forceinline__ T root_candidate(const F& f, const T& u, const T& v) {
  const T v2 = f.mul(v, v);
  const T v3 = f.mul(v2, v);
  const T v7 = f.mul(f.mul(v3, v3), v);
  const T w = f.mul(u, v7);
  return f.mul(f.mul(u, v3), pow_p58(f, w));
}

}  // namespace pow_p58

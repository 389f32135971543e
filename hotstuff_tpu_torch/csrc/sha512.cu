// FIPS 180-4 SHA-512 of a batch of messages, one message a thread.
//
// Replaces the jnp SHA-512 of the reference (hotstuff_tpu/ops/sha512.py:
// _compiled :149-177, _compress :102, _pad_messages :180), which runs under
// jax.jit with no Pallas kernel: 64-bit words as (hi, lo) uint32 pairs,
// because the TPU has no 64-bit integers, and messages of one length only,
// padded on the host. Here the words are native uint64_t, and every lane
// carries its own offset and length, so a drain of batches of mixed
// lengths hashes in one launch. Input: one packed byte buffer, an int64
// offset and an int64 length a lane. Output: the 64-byte digest a lane.
//
// Padding happens here, per lane: a lane of len bytes makes
// (len + 17 + 127) / 128 blocks (one for the empty lane); the byte after
// the message is 0x80, the last 16 bytes of the last block the 128-bit
// big-endian bit length (its high 64 bits are len >> 61). When
// len % 128 >= 112 the tail spills into an extra block.
//
// Bound on this card: 32-bit integer instructions. A 128-byte block is 80
// rounds and 64 schedule steps; a 64-bit rotate is two funnel shifts
// (SHF), a three-way xor or ch/maj one LOP3 a half, a 64-bit add of up to
// three terms an IADD3 and an IADD3.X: some 3,570 int32 instructions a
// block a lane (chip_smoke.py's SHA512_INT_OPS_PER_BLOCK), against 128
// bytes read.
//
// Design, right before fast: one thread a message, the eight-word state
// and a 16-word rolling schedule in registers, the 80 rounds unrolled, K in
// constant memory. Words load as aligned 8-byte loads where the lane's
// start is 8-aligned (the wrapper packs it so) and the word lies inside
// the message; the word at the end, and any lane that is not aligned, is
// assembled byte by byte. Lanes of very different lengths diverge within
// a warp, and a drain of 128 lanes fills one SM; spreading one message
// over several threads is later work.
#include <cstdint>

namespace {

constexpr int kThreads = 128;

__constant__ uint64_t kK[80] = {
    0x428A2F98D728AE22ull, 0x7137449123EF65CDull, 0xB5C0FBCFEC4D3B2Full, 0xE9B5DBA58189DBBCull,
    0x3956C25BF348B538ull, 0x59F111F1B605D019ull, 0x923F82A4AF194F9Bull, 0xAB1C5ED5DA6D8118ull,
    0xD807AA98A3030242ull, 0x12835B0145706FBEull, 0x243185BE4EE4B28Cull, 0x550C7DC3D5FFB4E2ull,
    0x72BE5D74F27B896Full, 0x80DEB1FE3B1696B1ull, 0x9BDC06A725C71235ull, 0xC19BF174CF692694ull,
    0xE49B69C19EF14AD2ull, 0xEFBE4786384F25E3ull, 0x0FC19DC68B8CD5B5ull, 0x240CA1CC77AC9C65ull,
    0x2DE92C6F592B0275ull, 0x4A7484AA6EA6E483ull, 0x5CB0A9DCBD41FBD4ull, 0x76F988DA831153B5ull,
    0x983E5152EE66DFABull, 0xA831C66D2DB43210ull, 0xB00327C898FB213Full, 0xBF597FC7BEEF0EE4ull,
    0xC6E00BF33DA88FC2ull, 0xD5A79147930AA725ull, 0x06CA6351E003826Full, 0x142929670A0E6E70ull,
    0x27B70A8546D22FFCull, 0x2E1B21385C26C926ull, 0x4D2C6DFC5AC42AEDull, 0x53380D139D95B3DFull,
    0x650A73548BAF63DEull, 0x766A0ABB3C77B2A8ull, 0x81C2C92E47EDAEE6ull, 0x92722C851482353Bull,
    0xA2BFE8A14CF10364ull, 0xA81A664BBC423001ull, 0xC24B8B70D0F89791ull, 0xC76C51A30654BE30ull,
    0xD192E819D6EF5218ull, 0xD69906245565A910ull, 0xF40E35855771202Aull, 0x106AA07032BBD1B8ull,
    0x19A4C116B8D2D0C8ull, 0x1E376C085141AB53ull, 0x2748774CDF8EEB99ull, 0x34B0BCB5E19B48A8ull,
    0x391C0CB3C5C95A63ull, 0x4ED8AA4AE3418ACBull, 0x5B9CCA4F7763E373ull, 0x682E6FF3D6B2B8A3ull,
    0x748F82EE5DEFB2FCull, 0x78A5636F43172F60ull, 0x84C87814A1F0AB72ull, 0x8CC702081A6439ECull,
    0x90BEFFFA23631E28ull, 0xA4506CEBDE82BDE9ull, 0xBEF9A3F7B2C67915ull, 0xC67178F2E372532Bull,
    0xCA273ECEEA26619Cull, 0xD186B8C721C0C207ull, 0xEADA7DD6CDE0EB1Eull, 0xF57D4F7FEE6ED178ull,
    0x06F067AA72176FBAull, 0x0A637DC5A2C898A6ull, 0x113F9804BEF90DAEull, 0x1B710B35131C471Bull,
    0x28DB77F523047D84ull, 0x32CAAB7B40C72493ull, 0x3C9EBE0A15C9BEBCull, 0x431D67C49C100D4Cull,
    0x4CC5D4BECB3E42B6ull, 0x597F299CFC657E2Aull, 0x5FCB6FAB3AD6FAECull, 0x6C44198C4A475817ull,
};

__device__ __forceinline__ uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// Word j of block b of a lane's padded message, big-endian.
__device__ __forceinline__ uint64_t padded_word(const uint8_t* msg, int64_t len, int64_t pos,
                                                bool aligned) {
  if (aligned && pos + 8 <= len) {
    const uint2 v = *reinterpret_cast<const uint2*>(msg + pos);
    return (static_cast<uint64_t>(bswap32(v.x)) << 32) | bswap32(v.y);
  }
  uint64_t word = 0;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int64_t q = pos + i;
    const uint64_t byte = q < len ? msg[q] : (q == len ? 0x80u : 0u);
    word = (word << 8) | byte;
  }
  return word;
}

__device__ __forceinline__ void compress(uint64_t (&s)[8], uint64_t (&w)[16]) {
  uint64_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    uint64_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr(w15, 1) ^ rotr(w15, 8) ^ (w15 >> 7);
      const uint64_t s1 = rotr(w2, 19) ^ rotr(w2, 61) ^ (w2 >> 6);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint64_t big_s1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t t1 = h + big_s1 + ch + kK[t] + wt;
    const uint64_t big_s0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
    const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + big_s0 + maj;
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

__global__ void __launch_bounds__(kThreads)
    sha512_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ offsets,
                  const int64_t* __restrict__ lengths, int n, uint8_t* __restrict__ out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const int64_t len = lengths[lane];
  const uint8_t* msg = data + offsets[lane];
  const bool aligned = (reinterpret_cast<uintptr_t>(msg) & 7) == 0;
  const int64_t blocks = (len + 17 + 127) / 128;
  uint64_t s[8] = {0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
                   0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
                   0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
  uint64_t w[16];
  for (int64_t blk = 0; blk < blocks; ++blk) {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = padded_word(msg, len, blk * 128 + 8 * j, aligned);
    if (blk == blocks - 1) {
      w[14] = static_cast<uint64_t>(len) >> 61;
      w[15] = static_cast<uint64_t>(len) << 3;
    }
    compress(s, w);
  }
  uint2* dst = reinterpret_cast<uint2*>(out + 64 * static_cast<int64_t>(lane));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dst[i] = make_uint2(bswap32(static_cast<uint32_t>(s[i] >> 32)),
                        bswap32(static_cast<uint32_t>(s[i])));
  }
}

}  // namespace

// data uint8 (the drain, packed), offsets and lengths int64 [n] (offsets
// into data), out uint8 [n, 64]; contiguous on the stream's device.
extern "C" int sha512_launch(const void* data, const void* offsets, const void* lengths, int n,
                             void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  sha512_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(lengths), n, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// FIPS 180-4 SHA-512 of a batch of messages: 32 messages a CTA, the
// message schedule on three producer warps, the 80-round chain on one.
//
// Replaces the jnp SHA-512 of the reference (hotstuff_tpu/ops/sha512.py:
// _compiled :149-177, _compress :102, _pad_messages :180), which runs under
// jax.jit with no Pallas kernel: 64-bit words as (hi, lo) uint32 pairs,
// because the TPU has no 64-bit integers, the schedule as its own scan
// (`extend` :112-127) ahead of the rounds (`round_step` :129-146), and
// messages of one length only, padded on the host. Here the words are
// native uint64_t, and every lane carries its own offset and length, so a
// drain of batches of mixed lengths hashes in one launch. Input: one packed
// byte buffer, an int64 offset and an int64 length a lane. Output: the
// 64-byte digest a lane.
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
// bytes read. That bound spreads a lane's blocks over the whole card; what
// sets the time is the chain. Round t needs the state after round t-1, and
// block b the state after block b-1. On the e-chain a round is four
// dependent instructions (SHF for Sigma1(e), LOP3 for its xor, then the
// IADD3 and IADD3.X of e' = (d + h + K[t] + W[t]) + Sigma1(e) + Ch(e, f, g)),
// everything else of the round can issue beside them.
//
// Design. The schedule depends only on a block's 16 words, never on the
// state (FIPS 180-4 6.4.2 step 1), so it leaves the chain:
// - Warps 1-3 are producers. For each stage of the ring, producer warp p
//   takes block k * 3 + p of every message the CTA owns (thread = message):
//   16-byte vector loads, byte swaps, the padding, the 64 extension steps,
//   and KW[t] = K[t] + W[t] written to shared memory. About 1,600
//   instructions a (message, block), on schedulers the chain warp does not
//   use.
// - Warp 0 is the chain: lane i runs message i's rounds, a..h in
//   registers, reading KW[t] from the ring. h + KW[t] and d + h + KW[t]
//   are formed one round ahead (round t+1's h is round t's g, its d is
//   round t's c), so they leave the e-chain: 28 SHF, LOP3 and IADD3 a
//   round (a few adds go to the FMA pipe as IMAD.X), 4 of them dependent
//   on e. One warp carries 32 messages for the price of one. Alone on its
//   scheduler, the chain warp is bound by that scheduler's int32 pipe,
//   16 lanes wide: each warp instruction holds it two cycles, some 56
//   cycles a round, about 2.6 us a block on the H100 (the 8-round loop
//   body keeps the code in the instruction cache). Moving the adds to the
//   FMA pipe (mad.wide.u32 by a 1 the compiler cannot see) was slower.
// - The ring is [stage][block][t][lane] of uint64_t, two stages of three
//   blocks (C = 3, one a producer warp), 120 kB of dynamic shared memory:
//   a warp's 32 reads or writes of one round are 256 contiguous bytes,
//   conflict-free. A stage holds 3 blocks of chain work (~13,000 cycles)
//   against one block of producer work a producer warp (~3,000), so the
//   producers stay a stage ahead. Named barriers hand the stages over:
//   full[s] (producers bar.arrive, the chain bar.sync) and empty[s] (the
//   chain bar.arrive, the producers bar.sync), each for all 128 threads,
//   as the PTX manual's producer/consumer example does.
// - Every warp of a CTA reads the 32 lengths and takes the most blocks of
//   a lane, so all four walk the same stages until the longest lane ends.
//   A lane that has ended, or lies past n, is masked: its producer skips
//   its block, its chain lane runs the rounds on whatever the ring holds
//   and drops the result. No thread returns early; the barriers stay
//   balanced (the chain releases a stage only where a producer will wait
//   for it).
// - Loads: the wrapper packs each lane on a 16-byte boundary, its span
//   rounded up to 16 bytes inside the buffer. A producer reads a 16-byte
//   chunk only where it holds a byte of its lane, so a read never leaves
//   the lane's 16-byte span; bytes past the length are masked to the
//   padding. A lane that is not 16-byte aligned, or whose span would end
//   past the buffer's nbytes (a caller other than the wrapper's pack), is
//   read byte by byte.
// - Grid: ceil(n / 32) CTAs of 128 threads, one a SM (the ring's 120 kB),
//   so a drain of 128 lanes spans 4 SMs and 1,024 challenges 32.
// - No tensor cores: SHA-512 has no matrix product.
//
// Left for later: the first stage's fill (a producer's loads and schedule,
// a few microseconds) is not overlapped with anything, which is most of a
// one-block drain's time; short drains leave most SMs idle, and a lane's
// blocks are one chain, so nothing splits them; the producers could use
// TMA, and warps 1-3 hand back no registers (setmaxnreg).
#include <cstdint>
#include <mutex>

namespace {

constexpr int kLanes = 32;                             // messages a CTA
constexpr int kProducers = 3;                          // producer warps
constexpr int kThreads = kLanes * (1 + kProducers);
constexpr int kRing = kProducers;                      // blocks a message a stage (C)
constexpr int kStages = 2;
constexpr int kRounds = 80;
constexpr int kBlockWords = kRounds * kLanes;          // one block of the ring
constexpr size_t kSmemBytes = sizeof(uint64_t) * kStages * kRing * kBlockWords;
constexpr int kFull = 1, kEmpty = 1 + kStages;         // named barrier ids, + stage

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

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// Two little-endian 32-bit loads as one big-endian 64-bit word.
__device__ __forceinline__ uint64_t be_word(uint32_t x, uint32_t y) {
  return (static_cast<uint64_t>(bswap32(x)) << 32) | bswap32(y);
}

__device__ __forceinline__ int64_t blocks_of(int64_t len) { return (len + 17 + 127) / 128; }

// A word of the padded message, given the message bytes that start at it
// (rem; the word's bytes past them are garbage or zero): the bytes past
// the message cleared, 0x80 at the first of them.
__device__ __forceinline__ uint64_t pad_word(uint64_t w, int64_t rem) {
  if (rem >= 8) return w;
  if (rem < 0) return 0;
  const int r = static_cast<int>(rem);
  const uint64_t keep = r == 0 ? 0 : ~0ull << (64 - 8 * r);
  return (w & keep) | (0x80ull << (56 - 8 * r));
}

// Word j of block blk of a lane that is not 16-byte aligned, byte by byte.
__device__ __forceinline__ uint64_t byte_word(const uint8_t* msg, int64_t len, int64_t pos) {
  uint64_t w = 0;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) w = (w << 8) | (pos + i < len ? msg[pos + i] : 0u);
  return w;
}

// The 16 words of block blk of a lane's padded message.
__device__ __forceinline__ void load_block(const uint8_t* msg, int64_t len, int64_t blk,
                                           int64_t blocks, bool vec, uint64_t (&w)[16]) {
  const int64_t base = blk * 128;
  if (vec && base + 128 <= len) {  // inside the message: never the last block
    const uint4* src = reinterpret_cast<const uint4*>(msg + base);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 v = __ldg(src + j);
      w[2 * j] = be_word(v.x, v.y);
      w[2 * j + 1] = be_word(v.z, v.w);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t pos = base + 16 * j;
    uint64_t w0 = 0, w1 = 0;
    if (pos < len) {
      if (vec) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(msg + pos));
        w0 = be_word(v.x, v.y);
        w1 = be_word(v.z, v.w);
      } else {
        w0 = byte_word(msg, len, pos);
        w1 = byte_word(msg, len, pos + 8);
      }
    }
    w[2 * j] = pad_word(w0, len - pos);
    w[2 * j + 1] = pad_word(w1, len - pos - 8);
  }
  if (blk == blocks - 1) {
    w[14] = static_cast<uint64_t>(len) >> 61;
    w[15] = static_cast<uint64_t>(len) << 3;
  }
}

__device__ __forceinline__ uint64_t sigma0(uint64_t x) { return rotr(x, 1) ^ rotr(x, 8) ^ (x >> 7); }
__device__ __forceinline__ uint64_t sigma1(uint64_t x) { return rotr(x, 19) ^ rotr(x, 61) ^ (x >> 6); }
__device__ __forceinline__ uint64_t big_sigma0(uint64_t x) {
  return rotr(x, 28) ^ rotr(x, 34) ^ rotr(x, 39);
}
__device__ __forceinline__ uint64_t big_sigma1(uint64_t x) {
  return rotr(x, 14) ^ rotr(x, 18) ^ rotr(x, 41);
}

// KW[t] = K[t] + W[t] of one block into the ring (dst: round 0 of this
// thread's lane; rounds kLanes words apart).
__device__ __forceinline__ void schedule(uint64_t (&w)[16], uint64_t* dst) {
#pragma unroll
  for (int t = 0; t < 16; ++t) dst[t * kLanes] = w[t] + kK[t];
#pragma unroll 1
  for (int t0 = 16; t0 < kRounds; t0 += 16) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      w[j] += sigma0(w[(j + 1) & 15]) + w[(j + 9) & 15] + sigma1(w[(j + 14) & 15]);
      dst[(t0 + j) * kLanes] = w[j] + kK[t0 + j];
    }
  }
}

__device__ void produce(uint64_t* ring, const uint8_t* data, int64_t nbytes, const int64_t* offsets,
                        int m, bool valid, int64_t len, int64_t blocks, int nstages, int p,
                        int lane) {
  const int64_t offset = valid ? offsets[m] : 0;
  const uint8_t* msg = data + offset;
  const bool vec = (reinterpret_cast<uintptr_t>(msg) & 15) == 0 &&
                   offset + ((len + 15) & ~15ll) <= nbytes;
#pragma unroll 1
  for (int k = 0; k < nstages; ++k) {
    const int s = k & 1;
    if (k >= kStages) bar_sync(kEmpty + s);
    const int64_t blk = static_cast<int64_t>(k) * kRing + p;
    if (blk < blocks) {
      uint64_t w[16];
      load_block(msg, len, blk, blocks, vec, w);
      schedule(w, ring + (s * kRing + p) * kBlockWords + lane);
    }
    __syncwarp();
    bar_arrive(kFull + s);
  }
}

// One round. The new e goes to d's register and the new a to h's, so the
// next round is sha_round(h, a, b, c, d, e, f, g, ...). hk = h + KW[t] and
// dhk = d + hk come in, and go out for the next round.
__device__ __forceinline__ void sha_round(uint64_t a, uint64_t b, uint64_t c, uint64_t& d, uint64_t e,
                                      uint64_t f, uint64_t g, uint64_t& h, uint64_t& hk,
                                      uint64_t& dhk, uint64_t kw_next) {
  const uint64_t s1 = big_sigma1(e);
  const uint64_t ch = g ^ (e & (f ^ g));
  const uint64_t t1 = hk + s1 + ch;
  d = dhk + s1 + ch;
  h = t1 + big_sigma0(a) + ((a & b) | (c & (a | b)));
  hk = g + kw_next;
  dhk = c + hk;
}

// One block's 80 rounds over the ring's KW (kw: round 0 of this lane),
// and the feed-forward where the lane is live.
__device__ __forceinline__ void compress(uint64_t (&st)[8], const uint64_t* kw, bool live) {
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5], g = st[6], h = st[7];
  uint64_t hk = h + kw[0];
  uint64_t dhk = d + hk;
#pragma unroll 1
  for (int t = 0; t < kRounds; t += 8) {
    uint64_t k[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = kw[min(t + 1 + i, kRounds - 1) * kLanes];
    sha_round(a, b, c, d, e, f, g, h, hk, dhk, k[0]);
    sha_round(h, a, b, c, d, e, f, g, hk, dhk, k[1]);
    sha_round(g, h, a, b, c, d, e, f, hk, dhk, k[2]);
    sha_round(f, g, h, a, b, c, d, e, hk, dhk, k[3]);
    sha_round(e, f, g, h, a, b, c, d, hk, dhk, k[4]);
    sha_round(d, e, f, g, h, a, b, c, hk, dhk, k[5]);
    sha_round(c, d, e, f, g, h, a, b, hk, dhk, k[6]);
    sha_round(b, c, d, e, f, g, h, a, hk, dhk, k[7]);
  }
  if (live) {
    st[0] += a;
    st[1] += b;
    st[2] += c;
    st[3] += d;
    st[4] += e;
    st[5] += f;
    st[6] += g;
    st[7] += h;
  }
}

__device__ void chain(const uint64_t* ring, int m, bool valid, int64_t blocks, int max_blocks,
                      int nstages, int lane, uint8_t* out) {
  uint64_t st[8] = {0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
                    0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
                    0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
#pragma unroll 1
  for (int k = 0; k < nstages; ++k) {
    const int s = k & 1;
    bar_sync(kFull + s);
#pragma unroll 1
    for (int b = 0; b < kRing; ++b) {
      const int64_t blk = static_cast<int64_t>(k) * kRing + b;
      if (blk >= max_blocks) break;
      compress(st, ring + (s * kRing + b) * kBlockWords + lane, blk < blocks);
    }
    if (k + kStages < nstages) bar_arrive(kEmpty + s);  // a producer waits for it
  }
  if (!valid) return;
  uint4* dst = reinterpret_cast<uint4*>(out + 64 * static_cast<int64_t>(m));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t x = st[2 * i], y = st[2 * i + 1];
    dst[i] = make_uint4(bswap32(static_cast<uint32_t>(x >> 32)), bswap32(static_cast<uint32_t>(x)),
                        bswap32(static_cast<uint32_t>(y >> 32)), bswap32(static_cast<uint32_t>(y)));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    sha512_kernel(const uint8_t* __restrict__ data, int64_t nbytes,
                  const int64_t* __restrict__ offsets, const int64_t* __restrict__ lengths, int n,
                  uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint64_t ring[];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int m = blockIdx.x * kLanes + lane;
  const bool valid = m < n;
  const int64_t len = valid ? lengths[m] : 0;
  const int64_t blocks = valid ? blocks_of(len) : 0;
  const int max_blocks = static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(blocks)));
  const int nstages = (max_blocks + kRing - 1) / kRing;
  if (warp == 0) {
    chain(ring, m, valid, blocks, max_blocks, nstages, lane, out);
  } else {
    produce(ring, data, nbytes, offsets, m, valid, len, blocks, nstages, warp - 1, lane);
  }
}

}  // namespace

// data uint8 [nbytes] (the drain, packed), offsets and lengths int64 [n]
// (offsets into data), out uint8 [n, 64]; contiguous on the stream's
// device, which is the current device.
extern "C" int sha512_launch(const void* data, int64_t nbytes, const void* offsets,
                             const void* lengths, int n, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // The ring is above the 48 kB a launch gets by default; the attribute is
  // set once a device, under a lock (launches come from worker threads).
  static std::mutex mu;
  static uint64_t ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    std::lock_guard<std::mutex> guard(mu);
    if (dev >= 64 || !(ready >> dev & 1)) {
      err = cudaFuncSetAttribute(sha512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemBytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) ready |= 1ull << dev;
    }
  }
  const int ctas = (n + kLanes - 1) / kLanes;
  sha512_kernel<<<ctas, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes, static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(lengths), n, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

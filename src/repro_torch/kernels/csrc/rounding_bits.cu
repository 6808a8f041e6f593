// The rounding bits of stochastic rounding, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The reference draws every rounding word with
// jax.random.bits(key, shape, uint32) (src/repro/core/bfp.py:289
// rounding_bits), which XLA fuses into the consumer of the bits; the
// port's plain version (core/prng.bits) runs threefry2x32 as about 170
// int64 elementwise torch ops a chunk.  This kernel draws the same words
// in one launch, in native uint32 arithmetic, one of three streams:
//
//   mode 0  jax.random.bits under jax_threefry_partitionable=True: word i is
//           the XOR of the two outputs of threefry2x32(key, (i >> 32,
//           i & 0xffffffff)); one thread a word;
//   mode 1  the same under jax_threefry_partitionable=False: the halves of
//           iota(n) (zero-padded to even length) hashed as pairs (j, h + j),
//           h = ceil(n / 2); word j is the first output, word h + j the
//           second; one thread a pair;
//   mode 2  the "hash" stream of repro.core.bfp._hash_bits: a multiply-
//           xorshift avalanche of the flat index, seeded with one threefry
//           word that the wrapper draws on the host.
//
// The key words arrive as arguments: the split / fold_in chains stay on
// the host.  Words are written as int64 holding the uint32 value, the
// contract of core/prng.bits, so every caller and every plain version is
// unchanged.
//
// Bound on the H100: the 8 bytes written a word, at 3.35 TB/s.  The hash
// is 2 + 5 * (4 * 3 + 2) = 72 integer operations (plus one XOR in mode 0,
// half as many a word in mode 1, about 10 in mode 2); at the SM's issue
// rate (four schedulers, one 32-lane instruction each a cycle; integer
// adds, shifts and logic go to the INT32 and the FMA pipes both) that is
// under the time of the writes.  Rotations are single funnel shifts and
// the round constants fold into the key words, so the kernel issues what
// the hash needs and nothing else; each warp writes 256 contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 with 20 rounds, as jax.random's: 5 groups of 4 rotations,
// a key injection after each group.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i % 2) ? 17 : 13, r1 = (i % 2) ? 29 : 15;
    const int r2 = (i % 2) ? 16 : 26, r3 = (i % 2) ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0); x1 ^= x0;
    x0 += x1; x1 = rotl(x1, r1); x1 ^= x0;
    x0 += x1; x1 = rotl(x1, r2); x1 ^= x0;
    x0 += x1; x1 = rotl(x1, r3); x1 ^= x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__global__ void __launch_bounds__(THREADS) bits_partitionable(
    long long* __restrict__ out, unsigned long long n, uint32_t k0, uint32_t k1) {
  const unsigned long long stride = (unsigned long long)gridDim.x * THREADS;
  for (unsigned long long i = (unsigned long long)blockIdx.x * THREADS + threadIdx.x;
       i < n; i += stride) {
    uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
    threefry(k0, k1, x0, x1);
    out[i] = (long long)(x0 ^ x1);
  }
}

__global__ void __launch_bounds__(THREADS) bits_iota_halves(
    long long* __restrict__ out, uint32_t n, uint32_t k0, uint32_t k1) {
  const uint32_t h = (uint32_t)(((unsigned long long)n + 1) / 2);
  const uint32_t stride = gridDim.x * THREADS;
  for (uint32_t j = blockIdx.x * THREADS + threadIdx.x; j < h; j += stride) {
    const bool second = (unsigned long long)h + j < n;
    uint32_t x0 = j, x1 = second ? h + j : 0u;
    threefry(k0, k1, x0, x1);
    out[j] = (long long)x0;
    if (second) out[h + j] = (long long)x1;
  }
}

__global__ void __launch_bounds__(THREADS) bits_hash(
    long long* __restrict__ out, unsigned long long n, uint32_t seed) {
  const unsigned long long stride = (unsigned long long)gridDim.x * THREADS;
  for (unsigned long long i = (unsigned long long)blockIdx.x * THREADS + threadIdx.x;
       i < n; i += stride) {
    uint32_t h = (uint32_t)i * 0x9E3779B1u ^ seed;
    h = (h ^ (h >> 15)) * 0x85EBCA77u;
    h = (h ^ (h >> 13)) * 0xC2B2AE3Du;
    out[i] = (long long)(h ^ (h >> 16));
  }
}

}  // namespace

extern "C" {

// out (n,) int64 <- n rounding words of stream `mode` (0 partitionable
// threefry, 1 the iota-halves threefry, n < 2^32 - 1, 2 the hash stream seeded
// with `seed`) under the key (k0, k1).
int repro_rounding_bits(void* out, long long n, unsigned k0, unsigned k1,
                        int mode, unsigned seed, void* stream) {
  if (n < 0 || mode < 0 || mode > 2 || (mode == 1 && n >= 0xFFFFFFFFll))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned long long items =
      mode == 1 ? ((unsigned long long)n + 1) / 2 : (unsigned long long)n;
  unsigned long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > 132ull * 64) blocks = 132ull * 64;
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<long long*>(out);
  if (mode == 0)
    bits_partitionable<<<(unsigned)blocks, THREADS, 0, s>>>(o, n, k0, k1);
  else if (mode == 1)
    bits_iota_halves<<<(unsigned)blocks, THREADS, 0, s>>>(o, (uint32_t)n, k0, k1);
  else
    bits_hash<<<(unsigned)blocks, THREADS, 0, s>>>(o, n, seed);
  return (int)cudaGetLastError();
}

}  // extern "C"

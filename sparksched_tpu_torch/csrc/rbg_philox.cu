// rbg random bits: JAX's `rbg` stream (lax.rng_bit_generator, Philox4x32-10
// as XLA lowers it) for one key, as 32-bit words or as float32 uniforms.
//
// Replaces: `lax.rng_bit_generator` under `jax_default_prng_impl = "rbg"`
// (jax/_src/prng.py `_rbg_random_bits`), which the JAX package reaches from
// every `jax.random.uniform` / `bits` / `randint` / `gumbel` / `permutation`
// draw once `fast_prng: True` switches the impl
// (sparksched_tpu/config.py:use_fast_prng). The JAX package has no Pallas
// kernel for it: XLA emits the generator as one op.
//
// The stream, as XLA:CPU produces it and the tests hold bit for bit:
// - the Philox key is the key's words (k0, k1);
// - the 128-bit counter of block i is the little-endian words
//   (k2, k3, k0, k1) plus i, with carry across all four words;
// - each block gives 4 words in order; the output is cut to n words.
// Under `vmap` JAX draws a batch of keys as ONE stream of the batch's first
// key over (batch..., shape) (the rng_bit_generator batching rule), so the
// wrapper hands this kernel the first key of its batch and the whole count.
//
// What bounds it: it reads 32 bytes of key and writes n words (8 bytes each
// as the port's int64 words, 4 as float32 uniforms); the arithmetic is 10
// rounds of two 32x32 multiplies (hi and lo) and a few xors/adds per block
// of 4 words, ~60 integer operations a block. Against the H100's rates the
// bytes bound it at every size the main path draws (PERF.md); at the main
// path's draws (a few hundred to ~10^5 words) the launch itself dominates.
//
// What the design does about it: one thread per block of 4 words, a
// grid-stride loop, the round function unrolled in registers with
// `__umulhi` for the high products and a 128-bit counter add with carry;
// each thread writes its 4 words contiguously. Nothing is staged in shared
// memory: no word is read twice.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

__device__ __forceinline__ void philox_block(uint32_t k0, uint32_t k1,
                                             uint32_t k2, uint32_t k3,
                                             unsigned long long blk,
                                             uint32_t out[4]) {
  // counter = (k2, k3, k0, k1) + blk, little-endian over 128 bits
  const unsigned long long lo0 = ((unsigned long long)k3 << 32) | k2;
  unsigned long long hi = ((unsigned long long)k1 << 32) | k0;
  const unsigned long long lo = lo0 + blk;
  hi += (lo < lo0) ? 1ull : 0ull;
  uint32_t c0 = (uint32_t)lo, c1 = (uint32_t)(lo >> 32);
  uint32_t c2 = (uint32_t)hi, c3 = (uint32_t)(hi >> 32);
  uint32_t a0 = k0, a1 = k1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0w = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1w = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ a0;
    const uint32_t n2 = hi0 ^ c3 ^ a1;
    c0 = n0;
    c1 = lo1w;
    c2 = n2;
    c3 = lo0w;
    a0 += kW0;
    a1 += kW1;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// mode 0: 32-bit words as int64 (the port's word convention);
// mode 1: float32 uniforms on [0, 1), jax.random.uniform's mapping
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    rbg_philox_kernel(const int64_t* __restrict__ key, void* __restrict__ out,
                      long long n) {
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const uint32_t k2 = (uint32_t)key[2], k3 = (uint32_t)key[3];
  const long long nb = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       b < nb; b += stride) {
    uint32_t w[4];
    philox_block(k0, k1, k2, k3, (unsigned long long)b, w);
    const long long base = 4 * b;
    const int cnt = (n - base) < 4 ? (int)(n - base) : 4;
    if (MODE == 0) {
      int64_t* o = static_cast<int64_t*>(out) + base;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < cnt) o[i] = (int64_t)w[i];
    } else {
      float* o = static_cast<float*>(out) + base;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < cnt) {
          const float f = __uint_as_float((w[i] >> 9) | 0x3F800000u) - 1.0f;
          o[i] = fmaxf(f, 0.0f);
        }
      }
    }
  }
}

}  // namespace

// key: device pointer to the first key's 4 int64 words; out: n int64 words
// (mode 0) or n float32 (mode 1). Launches on `stream`; returns
// cudaGetLastError() (0 on success), -1 on bad arguments.
extern "C" int rbg_random_bits_launch(const int64_t* key, void* out,
                                      long long n, int mode, void* stream) {
  if (n < 0 || (mode != 0 && mode != 1)) return -1;
  if (n == 0) return 0;
  const long long nb = (n + 3) / 4;
  long long blocks = (nb + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    rbg_philox_kernel<0><<<(unsigned)blocks, kThreads, 0, s>>>(key, out, n);
  else
    rbg_philox_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(key, out, n);
  return (int)cudaGetLastError();
}

// Two kernels of the port's random draws.
//
// 1. rbg random bits: JAX's `rbg` stream (lax.rng_bit_generator,
//    Philox4x32-10 as XLA lowers it) for one key, as 32-bit words or as
//    float32 uniforms: the draws that follow no split (the policy's Gumbel,
//    `randint`, `permutation`, the reset).
// 2. split_uniform: `(split(keys)[:, 0], uniform(split(keys)[:, 1], shape))`
//    for lane keys [B, W] in one launch, under either impl: the engine's
//    five split-then-draw sites (sparksched_tpu_torch/env/core.py
//    `_apply_action`, `_bulk_fulfill`, `_bulk_relaunch`, `_bulk_ready`,
//    and `_bulk_events_fused_ref`, the fused pass's plain version: on the
//    card that pass derives its uniforms inside `bulk_events.cu`).
//
// Replaces: `lax.rng_bit_generator` under `jax_default_prng_impl = "rbg"`
// (jax/_src/prng.py `_rbg_random_bits`), which the JAX package reaches from
// every `jax.random.uniform` / `bits` / `randint` / `gumbel` / `permutation`
// draw once `fast_prng: True` switches the impl
// (sparksched_tpu/config.py:use_fast_prng); and, in split_uniform, the
// `jax.random.split` + `jax.random.uniform` pairs of
// sparksched_tpu/env/core.py (:259-264, :575-579, :1120-1123, :1319-1322,
// :1570-1574) under either impl. The JAX package has no Pallas kernel for
// either: XLA emits the generator as one op and fuses the hash.
//
// The rbg stream, as XLA:CPU produces it and the tests hold bit for bit
// (prng_core.cuh: philox_block):
// - the Philox key is the key's words (k0, k1);
// - the 128-bit counter of block i is the little-endian words
//   (k2, k3, k0, k1) plus i, with carry across all four words;
// - each block gives 4 words in order; the output is cut to n words.
// Under `vmap` JAX draws a batch of keys as ONE stream of the batch's first
// key over (batch..., shape) (the rng_bit_generator batching rule), so the
// bits wrapper hands kernel 1 the first key of its batch and the whole
// count, and split_uniform draws the stream of split(keys[0])[1]: lane b
// takes words [b * n, (b + 1) * n), row-major over the draw's shape.
// Under threefry, split_uniform hashes each lane's own second key over the
// flat iota (prng_core.cuh: split_uniform_tf_item).
//
// What bounds them: kernel 1 reads 32 bytes of key and writes n words (8
// bytes each as the port's int64 words, 4 as float32 uniforms); the
// arithmetic is 10 rounds of two 32x32 multiplies (hi and lo) and a few
// xors/adds per block of 4 words, ~60 integer operations a block.
// split_uniform reads B keys and writes B next keys and B * n uniforms;
// it adds, per lane, threefry hashes (~80 operations each) for the next
// key (two under rbg) and, under threefry, two per word (the lane's second
// key, then the word). At the main path's draws (16 lanes, up to ~10^4
// words) every bound is well under a microsecond: the launch dominates.
//
// What the design does about it: one thread per block of 4 words (rbg) or
// per word (threefry) in a grid-stride loop, the rounds unrolled in
// registers; each thread writes its words contiguously. split_uniform
// under rbg derives the one Philox key from keys[0] once per block into
// shared memory (thread 0, then a barrier), so no second launch and no
// host copy come between the split and the draw; the first B threads also
// write the lanes' next keys. Keys are read through a row stride (views
// need no copy).

#include <cstdint>
#include <cuda_runtime.h>

#include "prng_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

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
    prng_core::philox_block(k0, k1, k2, k3, (unsigned long long)b, w);
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
        if (i < cnt) o[i] = prng_core::bits_to_uniform(w[i]);
      }
    }
  }
}

// split_uniform: items of prng_core::split_uniform_{tf,rbg}_item
template <bool RBG>
__global__ void __launch_bounds__(kThreads)
    split_uniform_kernel(const int64_t* __restrict__ keys,
                         long long key_stride, long long B, long long n,
                         long long items, int64_t* __restrict__ next,
                         float* __restrict__ u) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (RBG) {
    __shared__ uint32_t shared_sub[4];
    if (threadIdx.x == 0) prng_core::rbg_sub_key(keys, shared_sub);
    __syncthreads();
    const uint32_t sub[4] = {shared_sub[0], shared_sub[1], shared_sub[2],
                             shared_sub[3]};
    for (long long t = t0; t < items; t += stride)
      prng_core::split_uniform_rbg_item(keys, key_stride, B, n, sub, t, next,
                                        u);
  } else {
    for (long long t = t0; t < items; t += stride)
      prng_core::split_uniform_tf_item(keys, key_stride, B, n, t, next, u);
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
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    rbg_philox_kernel<0><<<(unsigned)blocks, kThreads, 0, s>>>(key, out, n);
  else
    rbg_philox_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(key, out, n);
  return (int)cudaGetLastError();
}

// keys: device pointer to B lane keys of 4 (rbg = 1) or 2 (rbg = 0) int64
// words, lane b's at keys + b * key_stride; next: B * W int64 words (each
// lane's split(key)[0]); u: B * n float32 (uniform(split(keys)[:, 1], n)
// as the JAX package draws it under vmap). Launches on `stream`; returns
// cudaGetLastError() (0 on success), -1 on bad arguments.
extern "C" int split_uniform_launch(const int64_t* keys, long long key_stride,
                                    long long B, int rbg, long long n,
                                    int64_t* next, float* u, void* stream) {
  if (B < 0 || n < 0 || (rbg != 0 && rbg != 1)) return -1;
  if (B == 0) return 0;
  const long long draw = rbg ? (B * n + 3) / 4 : B * n;
  const long long items = draw > B ? draw : B;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rbg)
    split_uniform_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        keys, key_stride, B, n, items, next, u);
  else
    split_uniform_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        keys, key_stride, B, n, items, next, u);
  return (int)cudaGetLastError();
}

// threefry2x32: jax.random's default key chain and draws in one launch --
// `split`, `fold_in` and `random_bits` / `uniform` under threefry2x32 with
// `jax_threefry_partitionable` on (jax 0.9.0), and `split` / `fold_in` of
// an rbg key, whose two 2-word halves hash alike.
//
// Replaces: the XLA-compiled `threefry2x32_p` that jax/_src/prng.py's
// `threefry_split`, `threefry_fold_in` and `threefry_random_bits` bind,
// reached from every `jax.random.split` / `fold_in` / `bits` / `uniform`
// of the JAX package (sparksched_tpu/env/core.py, env/flat_loop.py,
// trainers/, serve/session.py, workload/sampling.py). The JAX package has
// no Pallas kernel for it: XLA fuses the hash into the jitted program. The
// port hashed in plain int64 torch ops, ~155 launches a hash.
//
// What it computes, per key k of K, counter i of n, half h (2 for rbg):
// threefry2x32 under the key's words (2h, 2h + 1) of the 64-bit counter
// base + i as words (c >> 32, c & 0xFFFFFFFF) -- split's counters are
// (0, i), fold_in's (0, data), random_bits' the flat iota. Outputs go
// straight into the layout the wrapper returns (prng_core.cuh:
// threefry_item): the two words [K, n, 2 * halves] (split under both
// impls, with no reorder of the rbg halves), a ^ b as int64 [K, n], or
// jax.random.uniform's float32 [K, n].
//
// What bounds it: each key is read once (16 or 32 bytes), each output
// written once (8 bytes a word, 4 a uniform); the hash is 20 rounds of an
// add, a rotate and a xor plus 5 key injections, ~80 integer operations.
// At the main path's sizes (one key to 16 x 4,000 counters) both bounds
// are well under a microsecond: the launch is the cost, as it was the
// cost of the ~155 launches this replaces.
//
// What the design does about it: one thread per (key, counter, half) in a
// grid-stride loop, the hash unrolled in registers; keys read through a
// row stride so a view like keys[:, 0] of a [B, 2, W] tensor needs no
// copy. Nothing is staged in shared memory: no word is read twice by a
// block.

#include <cstdint>
#include <cuda_runtime.h>

#include "prng_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

__global__ void __launch_bounds__(kThreads)
    threefry2x32_kernel(const int64_t* __restrict__ keys, long long key_stride,
                        int halves, unsigned long long base, long long n,
                        int mode, long long total, void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride)
    prng_core::threefry_item(keys, key_stride, halves, base, n, mode, t, out);
}

}  // namespace

// keys: device pointer to K keys of 2 * halves int64 words, key k at
// keys + k * key_stride; out: K * n * 2 * halves int64 words (mode 0,
// pair), K * n int64 words (mode 1, bits) or K * n float32 (mode 2,
// uniform); halves = 2 (an rbg key) only in mode 0. Launches on `stream`;
// returns cudaGetLastError() (0 on success), -1 on bad arguments.
extern "C" int threefry2x32_launch(const int64_t* keys, long long key_stride,
                                   long long num_keys, int halves,
                                   unsigned long long base, long long n,
                                   int mode, void* out, void* stream) {
  if (num_keys < 0 || n < 0 || (halves != 1 && halves != 2) || mode < 0 ||
      mode > 2 || (halves == 2 && mode != prng_core::kModePair))
    return -1;
  const long long total = num_keys * n * halves;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  threefry2x32_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      keys, key_stride, halves, base, n, mode, total, out);
  return (int)cudaGetLastError();
}

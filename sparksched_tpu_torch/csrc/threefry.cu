// threefry2x32: jax.random's default key chain and draws, every key a
// path of counters from a root -- `split`, `fold_in` and `random_bits` /
// `uniform` under threefry2x32 with `jax_threefry_partitionable` on (jax
// 0.9.0), and `split` / `fold_in` of an rbg key, whose two 2-word halves
// hash alike -- with a call site's whole key chain in one launch.
//
// Replaces: the XLA-compiled `threefry2x32_p` that jax/_src/prng.py's
// `threefry_split`, `threefry_fold_in` and `threefry_random_bits` bind,
// reached from every `jax.random.split` / `fold_in` / `bits` / `uniform`
// of the JAX package (sparksched_tpu/env/core.py, env/flat_loop.py,
// trainers/, serve/session.py, workload/sampling.py). The JAX package has
// no Pallas kernel for it: XLA fuses the hash into the jitted program.
//
// What it computes: in partitionable mode `split(k, n)[i]` and
// `fold_in(k, i)` are the same hash, threefry2x32 of the 64-bit counter
// i (words (i >> 32, i & 0xFFFFFFFF)) under k, so every derived key is a
// root hashed through a short path of counters: the collector's lane
// keys are (1, b, 0), its drain keys (3, b), PPO's permutation keys (13,
// e, b). Per root r of R, path p of P (a row of an int64 table on the
// device: counters, the launch's one varying counter `var`, padding),
// counter j of n, half h (2 for rbg): the root's half through the path's
// hops, the last hop at its counter + j (split's fan-out, or a draw's
// iota). Outputs go straight into the layout the wrapper returns
// (prng_core.cuh: threefry_path_item): the two words [R, P, n,
// 2 * halves], a ^ b as int64 [R, P, n], or jax.random.uniform's
// float32. A plain split, fold_in or draw is a path of depth 1.
//
// What bounds it: each root is read once (16 or 32 bytes), the table
// (P x depth int64) once, each output written once (8 bytes a word, 4 a
// uniform); a hop is 20 rounds of an add, a rotate and a xor plus 5 key
// injections, ~80 integer operations. At the main path's sizes (66 paths
// of <= 3 hops from one key, to one key's 4,000-counter draw) both
// bounds are well under a microsecond: the launch and the wrapper's host
// work are the cost, so the design is about launches, not the body.
//
// What the design does about it: a call site's whole chain is one launch
// (the tables are built once per site and shape and cached on the
// device by the caller; the one counter that changes per call, such as
// the served call's count, is the scalar `var`, so no table is written
// per call). One thread per (root, path, counter, half) in a grid-stride
// loop, the hops unrolled in registers; roots read through a row stride
// so a view like keys[:, 0] of a [B, 2, W] tensor needs no copy. Nothing
// is staged in shared memory: no word is read twice by a thread, and the
// few table rows a block reads stay in L1.

#include <cstdint>
#include <cuda_runtime.h>

#include "prng_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

__global__ void __launch_bounds__(kThreads)
    threefry2x32_kernel(const int64_t* __restrict__ roots,
                        long long root_stride, int halves,
                        const int64_t* __restrict__ paths, int depth,
                        long long num_paths, unsigned long long var,
                        long long n, int mode, long long total,
                        void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride)
    prng_core::threefry_path_item(roots, root_stride, halves, paths, depth,
                                  num_paths, var, n, mode, t, out);
}

}  // namespace

// roots: device pointer to R keys of 2 * halves int64 words, root r at
// roots + r * root_stride; paths: device pointer to a [P, depth] int64
// table (prng_core.cuh: kPathVar, kPathEnd); out: R * P * n * 2 * halves
// int64 words (mode 0, pair), R * P * n int64 words (mode 1, bits) or
// R * P * n float32 (mode 2, uniform); halves = 2 (an rbg key) only in
// mode 0. Launches on `stream`; returns cudaGetLastError() (0 on
// success), -1 on bad arguments.
extern "C" int threefry2x32_launch(const int64_t* roots, long long root_stride,
                                   long long num_roots, int halves,
                                   const int64_t* paths, int depth,
                                   long long num_paths,
                                   unsigned long long var, long long n,
                                   int mode, void* out, void* stream) {
  if (num_roots < 0 || num_paths < 0 || n < 0 || depth < 1 ||
      depth > prng_core::kMaxPathDepth || (halves != 1 && halves != 2) ||
      mode < 0 || mode > 2 || (halves == 2 && mode != prng_core::kModePair))
    return -1;
  const long long total = num_roots * num_paths * n * halves;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  threefry2x32_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      roots, root_stride, halves, paths, depth, num_paths, var, n, mode,
      total, out);
  return (int)cudaGetLastError();
}

// The arithmetic of the port's two PRNG kernels, as `__host__ __device__`
// inline functions: jax 0.9.0's threefry2x32 hash (20 rounds, the
// `_threefry2x32_lowering` schedule), the Philox4x32-10 block of
// `lax.rng_bit_generator` under `rbg`, jax.random.uniform's float32
// mapping, and the per-thread body of each kernel (`threefry_path_item`,
// `split_uniform_tf_item`, `split_uniform_rbg_item`) with the word-level
// pieces they share, which `engine_core.cuh` calls to derive the one pair
// of uniforms a fused bulk-pass step consumes. `threefry.cu` and
// `rbg_philox.cu` only add the launch around these bodies.
//
// Under plain g++ (no `__CUDACC__`) the CUDA qualifiers become `inline`
// and the intrinsics their host forms, so the header also compiles as C++:
// tests/test_torch_threefry.py builds it into a small shared library and
// holds every body here against jax.random on the CPU.
//
// Words: keys and 32-bit outputs live in int64 (the port's convention;
// only the low 32 bits of a key word are read), uniforms are float32.

#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define PRNG_HD __host__ __device__ __forceinline__
#else
#define PRNG_HD inline
#endif

namespace prng_core {

constexpr uint32_t kParity = 0x1BD11BDAu;  // threefry's key-schedule parity
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr uint64_t kM32 = 0xFFFFFFFFull;

PRNG_HD uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// four of threefry's rounds with rotations r0..r3
PRNG_HD void mix4(uint32_t& a, uint32_t& b, int r0, int r1, int r2, int r3) {
  a += b; b = rotl32(b, r0) ^ a;
  a += b; b = rotl32(b, r1) ^ a;
  a += b; b = rotl32(b, r2) ^ a;
  a += b; b = rotl32(b, r3) ^ a;
}

// threefry2x32 of the counter (x0, x1) under the key (k0, k1): jax's
// five groups of four rounds, each followed by a key injection
PRNG_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                          uint32_t& o0, uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t a = x0 + k0, b = x1 + k1;
  mix4(a, b, 13, 15, 26, 6);  a += k1; b += k2 + 1u;
  mix4(a, b, 17, 29, 16, 24); a += k2; b += k0 + 2u;
  mix4(a, b, 13, 15, 26, 6);  a += k0; b += k1 + 3u;
  mix4(a, b, 17, 29, 16, 24); a += k1; b += k2 + 4u;
  mix4(a, b, 13, 15, 26, 6);  a += k2; b += k0 + 5u;
  o0 = a;
  o1 = b;
}

// the hash of the 64-bit counter c, split into words (c >> 32, c & M) as
// jax's partitionable iota (split, fold_in and random_bits all count so)
PRNG_HD void threefry_at(uint32_t k0, uint32_t k1, uint64_t c, uint32_t& o0,
                         uint32_t& o1) {
  threefry2x32(k0, k1, (uint32_t)(c >> 32), (uint32_t)(c & kM32), o0, o1);
}

PRNG_HD uint32_t mulhi32(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// Philox4x32-10 block `blk` of the rbg key (k0, k1, k2, k3): the Philox
// key is (k0, k1); the 128-bit counter is the little-endian words
// (k2, k3, k0, k1) plus blk, with carry across all four words
PRNG_HD void philox_block(uint32_t k0, uint32_t k1, uint32_t k2, uint32_t k3,
                          uint64_t blk, uint32_t out[4]) {
  const uint64_t lo0 = ((uint64_t)k3 << 32) | k2;
  uint64_t hi = ((uint64_t)k1 << 32) | k0;
  const uint64_t lo = lo0 + blk;
  hi += (lo < lo0) ? 1ull : 0ull;
  uint32_t c0 = (uint32_t)lo, c1 = (uint32_t)(lo >> 32);
  uint32_t c2 = (uint32_t)hi, c3 = (uint32_t)(hi >> 32);
  uint32_t a0 = k0, a1 = k1;
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = mulhi32(kPhiloxM0, c0), lo0w = kPhiloxM0 * c0;
    const uint32_t hi1 = mulhi32(kPhiloxM1, c2), lo1w = kPhiloxM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ a0;
    const uint32_t n2 = hi0 ^ c3 ^ a1;
    c0 = n0;
    c1 = lo1w;
    c2 = n2;
    c3 = lo0w;
    a0 += kPhiloxW0;
    a1 += kPhiloxW1;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// jax.random.uniform's float32 on [0, 1) from 32 random bits
PRNG_HD float bits_to_uniform(uint32_t w) {
  const uint32_t f = (w >> 9) | 0x3F800000u;
#if defined(__CUDA_ARCH__)
  return fmaxf(__uint_as_float(f) - 1.0f, 0.0f);
#else
  float x;
  std::memcpy(&x, &f, sizeof x);
  x -= 1.0f;
  return x > 0.0f ? x : 0.0f;
#endif
}

// Output modes of threefry2x32_launch
constexpr int kModePair = 0;     // the two words (split, fold_in)
constexpr int kModeBits = 1;     // a ^ b (random_bits)
constexpr int kModeUniform = 2;  // float32 through bits_to_uniform

// A path table's entries: a counter c >= 0, kPathVar (the launch's one
// varying counter), or any other negative value, which ends the path
// (tables pad short paths with kPathEnd)
constexpr int64_t kPathEnd = -1;
constexpr int64_t kPathVar = -2;
constexpr int kMaxPathDepth = 8;

// The hops of a path row of `depth` entries: the entries before the
// first end
PRNG_HD int path_hops(const int64_t* row, int depth) {
  int len = 0;
  while (len < depth && (row[len] >= 0 || row[len] == kPathVar)) ++len;
  return len;
}

// The key (k0, k1) hashed through the path's hops in place: hop d is
// threefry of the 64-bit counter row[d] (`var` for kPathVar), the last
// hop at its counter + j. fold_in(k, c) and split(k, n)[c] are both this
// hop, so a chain of them from a root is one path.
PRNG_HD void hash_path(uint32_t& k0, uint32_t& k1, const int64_t* row,
                       int hops, uint64_t var, uint64_t j) {
  for (int d = 0; d < hops; ++d) {
    const uint64_t c = (row[d] == kPathVar ? var : (uint64_t)row[d]) +
                       (d == hops - 1 ? j : 0ull);
    uint32_t a, b;
    threefry_at(k0, k1, c, a, b);
    k0 = a;
    k1 = b;
  }
}

// Item t of threefry2x32_launch over R roots x P paths x n counters x
// halves (halves = 2 for an rbg key, whose halves hash alike): half
// h = t % halves, counter j = (t / halves) % n, path p = (t / (halves *
// n)) % P, root r = t / (halves * n * P). Root r's words start at
// roots + r * root_stride (adjacent words); path p is the table row
// paths + p * depth. The root's half h goes through the path
// (hash_path, the last hop at its counter + j). Pair mode writes
// out[2t], out[2t + 1] as int64: the layout [R, P, n, 2 * halves], the
// halves side by side; bits mode out[t] = a ^ b as int64 and uniform
// mode out[t] as float32, [R, P, n] (halves = 1 there). A path of no hop
// leaves the root's words as they are.
PRNG_HD void threefry_path_item(const int64_t* roots, long long root_stride,
                                int halves, const int64_t* paths, int depth,
                                long long num_paths, uint64_t var,
                                long long n, int mode, long long t,
                                void* out) {
  const long long h = t % halves;
  const long long rest = t / halves;
  const long long j = rest % n;
  const long long p = (rest / n) % num_paths;
  const long long r = rest / n / num_paths;
  const int64_t* key = roots + r * root_stride + 2 * h;
  const int64_t* row = paths + p * depth;
  uint32_t a = (uint32_t)key[0], b = (uint32_t)key[1];
  hash_path(a, b, row, path_hops(row, depth), var, (uint64_t)j);
  if (mode == kModePair) {
    int64_t* o = static_cast<int64_t*>(out) + 2 * t;
    o[0] = (int64_t)a;
    o[1] = (int64_t)b;
  } else if (mode == kModeBits) {
    static_cast<int64_t*>(out)[t] = (int64_t)(a ^ b);
  } else {
    static_cast<float*>(out)[t] = bits_to_uniform(a ^ b);
  }
}

// split(key)[0] of one lane key of `w` words (2, or 4 under rbg: each
// half at counter 0) into next[0..w)
PRNG_HD void split_next_key(const int64_t* key, int w, int64_t* next) {
  for (int h = 0; h < w; h += 2) {
    uint32_t a, b;
    threefry_at((uint32_t)key[h], (uint32_t)key[h + 1], 0, a, b);
    next[h] = (int64_t)a;
    next[h + 1] = (int64_t)b;
  }
}

// split(key)[1] of a threefry key (counter 1): the key whose iota a
// lane's split-then-draw hashes
PRNG_HD void split_tf_sub_key(const int64_t* key, uint32_t& s0,
                              uint32_t& s1) {
  threefry_at((uint32_t)key[0], (uint32_t)key[1], 1, s0, s1);
}

// word j of uniform(sub, ...) for the threefry key (s0, s1)
PRNG_HD float uniform_tf_word(uint32_t s0, uint32_t s1, uint64_t j) {
  uint32_t a, b;
  threefry_at(s0, s1, j, a, b);
  return bits_to_uniform(a ^ b);
}

// split_uniform under threefry, item t of max(B, B * n): for t < B,
// lane t's next key split(key)[0] (counter 0) into next[2t..2t+1]; for
// t < B * n, word j = t % n of lane b = t / n: the uniform of lane b's
// second key split(key)[1] (counter 1) at counter j, into u[t].
PRNG_HD void split_uniform_tf_item(const int64_t* keys, long long key_stride,
                                   long long B, long long n, long long t,
                                   int64_t* next, float* u) {
  if (t < B) split_next_key(keys + t * key_stride, 2, next + 2 * t);
  if (t < B * n) {
    const long long lane = t / n, j = t % n;
    uint32_t s0, s1;
    split_tf_sub_key(keys + lane * key_stride, s0, s1);
    u[t] = uniform_tf_word(s0, s1, (uint64_t)j);
  }
}

// rbg: the second key of split(keys[0]), both halves at counter 1 -- the
// one key whose Philox stream a vmapped draw over the batch takes
PRNG_HD void rbg_sub_key(const int64_t* key0, uint32_t sub[4]) {
  threefry_at((uint32_t)key0[0], (uint32_t)key0[1], 1, sub[0], sub[1]);
  threefry_at((uint32_t)key0[2], (uint32_t)key0[3], 1, sub[2], sub[3]);
}

// split_uniform under rbg, item t of max(B, ceil(B * n / 4)): for t < B,
// lane t's next key (each half at counter 0) into next[4t..4t+3]; for
// t < ceil(B * n / 4), Philox block t of `sub` (rbg_sub_key) as uniforms
// u[4t..4t+3], cut at B * n: lane b's words are [b * n, (b + 1) * n) of
// the one stream, in row-major order.
PRNG_HD void split_uniform_rbg_item(const int64_t* keys, long long key_stride,
                                    long long B, long long n,
                                    const uint32_t sub[4], long long t,
                                    int64_t* next, float* u) {
  if (t < B) split_next_key(keys + t * key_stride, 4, next + 4 * t);
  const long long total = B * n;
  if (4 * t < total) {
    uint32_t w[4];
    philox_block(sub[0], sub[1], sub[2], sub[3], (uint64_t)t, w);
    const long long base = 4 * t;
    const int cnt = (total - base) < 4 ? (int)(total - base) : 4;
    for (int i = 0; i < 4; ++i)
      if (i < cnt) u[base + i] = bits_to_uniform(w[i]);
  }
}

// words g and g + 1 (g even) of the Philox stream of `sub` as uniforms:
// one block holds both (a split-then-draw's pair of a step and executor)
PRNG_HD void uniform_rbg_pair(const uint32_t sub[4], uint64_t g, float& u0,
                              float& u1) {
  uint32_t w[4];
  philox_block(sub[0], sub[1], sub[2], sub[3], g >> 2, w);
  const int i = (int)(g & 3);  // by selects: w stays in registers
  u0 = bits_to_uniform(i == 0 ? w[0] : i == 1 ? w[1] : w[2]);
  u1 = bits_to_uniform(i == 0 ? w[1] : i == 1 ? w[2] : w[3]);
}

}  // namespace prng_core

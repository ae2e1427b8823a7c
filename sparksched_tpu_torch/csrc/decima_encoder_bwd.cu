// Decima NodeEncoder backward: the gradient of the GNN's level-wise message
// pass with respect to the weights and biases of its three MLPs (prep, msg,
// update), given the gradient of its output h_node.
//
// Replaces: the gradient XLA derives, under jax.checkpoint, for the
// NodeEncoder part of sparksched_tpu/schedulers/decima.py
// `DecimaNet.__call__` (:284-326) inside `DecimaScheduler.evaluate_actions`
// (:706-728) — the PPO update's jax.grad. The JAX package has no Pallas
// kernel for it. The forward is csrc/decima_encoder.cu; this kernel follows
// the JAX semantics, not the forward kernel's message cache:
//   h_init = prep(x); h0 = where(has_child, 0, update(h_init));
//   for lvl = nl-1 .. 0: h = where(level == lvl & has_child,
//                                  h_init + update(adj @ msg(h)), h);
//   h = h_init on an edgeless item; out = where(node_mask, h, 0).
// A node is updated at most once, at its own level (when it has a child and
// 0 <= level < nl), so its h takes two values: h0 before that step and
// h_fin after it. The parent updated at step lvl reads msg(h_fin[c]) from a
// child c updated at an earlier step (U[c] and level[c] > lvl) and
// msg(h0[c]) otherwise — whatever the levels are, topological or not. A
// job's backward recomputes its forward keeping both versions, then sweeps
// the levels in the reverse order (0 .. nl-1): at step lvl the fin-version
// message gradient of the nodes updated there is complete (its readers sit
// at lower levels), so it is pushed back into their h_fin; the update MLP's
// backward gives the gradient of their aggregation, which is scattered
// along their edges into the children's message gradients. After the sweep
// the h0-version messages, the leaves' update and prep are pushed back.
// The rows computed are those of a dense JAX program: prep, update(h_init)
// and msg(h0) over all S rows; at a level step update over its own rows and
// msg over them when the level is >= 1 (msg(h_fin) of a level-0 node is
// never taken in JAX: its readers would sit below level 0). Nothing is
// pruned by node_mask or by a zero delta, so non-finite values spread as in
// jax.grad: 0 x NaN is NaN. A job with no valid node contributes exactly 0;
// on an edgeless item prep alone carries the gradient.
//
// What bounds it: per live job ~20k warp-instructions (the forward, the
// input gradients, the weight gradients, ~10k FMAs a lane) in chains of
// dependent shared- and global-memory loads: on an H100 a lone warp takes
// ~256k cycles a job, and 16 warps an SM overlap only 5x, with neither
// the FMA pipes nor shared memory's 128 bytes a cycle near saturation.
// The bytes of a call (x, adj, levels, mask, dL/dh) are a few hundred MB
// at most, below 0.14 ms of HBM; the FLOPs the data needs below 0.2 ms of
// FP32 (PERF.md has the kernel's time beside its bound and the clock
// counts).
//
// What the design does about it:
// - A live-job list built on the card. `live_count_kernel` counts, per
//   block of 256 jobs, the jobs with a valid node; `live_list_kernel` turns
//   the counts into offsets and writes each live job, in job order, with
//   its node_mask bits and edgeless flag, to its slot; the count stays on
//   the card. A dead job costs its S node_mask bytes.
// - A warp per live job, persistent: one block of up to 16 warps per SM
//   sharing one copy of the weights in shared memory (the padded layout
//   below), each warp with ~13 KB of its own scratch at the flagship widths
//   (S = 20, embed 16, hidden [32, 16]). Warp w of W takes the live slots
//   w, w + W, w + 2W, ... in order: a fixed assignment, so every sum's
//   order depends only on the inputs. No block barrier after the weights
//   are staged: a job's steps are ordered by __syncwarp.
// - Row passes (prep, update(h_init), msg(h0) over all S rows, and their
//   input gradients): a lane computes 4 x 4 tiles (4 rows, interleaved so
//   a quarter-warp's row loads hit distinct banks, by 4 outputs), 16 FMAs
//   per two 16-byte loads: 2 bytes of shared memory per FMA, where a lane
//   per row (the first version) needed 4.25. The forward saves each row
//   pass's hidden pre-activations to the warp's global scratch, and its
//   backward copies them back by cp.async instead of recomputing them.
// - Level steps (the 1-3 rows updated at a level): the warp spreads those
//   rows' layer outputs (forward) or inputs (backward) over its lanes, one
//   per lane; the aggregation and the scatter along the edges go through
//   the warp's buffers the same way.
// - Weight gradients leave the level chain. The forward of a level step
//   records each MLP application's input and pre-activations, its backward
//   the deltas, in the warp's record rows (global memory, one row per
//   node). The weight gradient of each MLP is then taken once per job,
//   over all its rows: the S rows of its row pass, read from shared memory,
//   then the recorded level rows in node order. A lane owns a 4 x 4 tile of
//   a layer's W^T (and, for the tiles of the first four inputs, 4 biases)
//   and adds the job's sum to the warp's own accumulator (global memory, in
//   the padded layout). `reduce_warps_kernel` adds the accumulators of
//   groups of 64 warps in warp order, `reduce_groups_kernel` the groups in
//   group order into the packed layout: no float atomics, so a rerun gives
//   the same bits. Records indexed by live job, summed by a separate
//   split-K kernel, were the alternative: the live count stays on the card,
//   so they would need room for every job of the call (2.6 GB at [256, 200,
//   20], 10.3 GB at [1024, 200, 20]); the accumulators, record rows and
//   saved pre-activations take ~110 MB whatever the call's size.
// - One copy of each pass in the binary: the passes are called, not
//   inlined, and read the layer table from shared memory. Inlined at each
//   call site the kernel was 11.6k instructions (186 KB); called, 7.5k.
// - Asynchronous copies: the next live job's x goes into the warp's second
//   x buffer by cp.async while the warp computes the current job; the
//   current job's dL/dh goes into its buffer the same way during the
//   forward; the next job's adjacency rows and levels are loaded into
//   registers a job ahead.
// - No tensor cores: every weight tile is at most 32 x 32, below wgmma's
//   64-row tile, and plain TF32 keeps ~1e-3 relative precision, far from
//   the 1e-4 tolerance against the float64 plain backward; 3xTF32 on
//   mma.sync (three products per tile) would trade the shared-memory
//   traffic for fragment shuffles at 3x the issue slots, untried. Plain
//   FP32 FMAs on the CUDA cores.
//
// Limits: S <= 32 (a job's nodes are a warp's lanes and adjacency rows are
// 32-bit masks), MLPs of 1 to 4 layers, layers at most 64 wide.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (sparksched_tpu_torch/kernels/build.py); bound
// with ctypes through the plain C entry points at the bottom.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 4
#define MAX_WIDTH 64
#define MAX_WARPS 16   // warps per block; one block per SM
#define LIST_THREADS 256
#define GROUP_WARPS 64 // accumulators summed per group by reduce_warps_kernel
#define SLACK 16       // zero floats after the weights (chunked reads may run past)
#define SMEM_MAX (227 * 1024)
#define DIMS_FLOATS 256  // shared floats holding the Dims table (>= sizeof(Dims) / 4)
#define FULL 0xffffffffu

struct Mlp {
  int n;                   // dense layers
  int in[MAX_LAYERS];
  int out[MAX_LAYERS];
  int in4[MAX_LAYERS];     // in rounded up to 4: rows of the padded W^T
  int rs[MAX_LAYERS];      // padded W^T row stride: out rounded up, 4 mod 8
  int off[MAX_LAYERS];     // padded offset of W^T (in4 x rs); the bias (rs) follows
  int poff[MAX_LAYERS];    // packed offset of W^T (in x out); the bias (out) follows
  int hoff[MAX_LAYERS];    // hidden layer l's pre-activations in a Z row
  int rz[MAX_LAYERS];      // record: hidden layer l's pre-activations
  int rd[MAX_LAYERS];      // record: layer l's delta
  int rlen;                // record floats: the input, the hidden, the deltas
};

struct Dims {
  Mlp prep, msg, upd;
  int S, F, D, nl, K, J;
  int wtot;                // padded weight floats (multiple of 4)
  int ptot;                // packed floats the gradient holds (multiple of 4)
  int Fp, Dp, Hp;          // row strides: x, [S, D] buffers, Z
  int aggz;                // the aggregation's column in Z (update of 1 layer), else -1
  int RS;                  // record floats per node: update's, then msg's
  int warp_floats;         // per-warp shared floats
  int wpb, W;              // warps per block, warps launched
  int G;                   // groups of GROUP_WARPS accumulators
  int x16, g16, adjw;      // 16-byte copies of x and dL/dh rows; adjacency words
  float slope;
};

static_assert(sizeof(Dims) <= DIMS_FLOATS * 4, "Dims outgrew its shared slot");

extern __shared__ __align__(16) float sm[];

__device__ __forceinline__ float act(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// d act / d pre: 1 where pre >= 0, else slope (NaN included, as torch.where)
__device__ __forceinline__ float dact(float pre, float slope) {
  return pre >= 0.f ? 1.f : slope;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 act4(float4 v, float slope) {
  return make_float4(act(v.x, slope), act(v.y, slope), act(v.z, slope),
                     act(v.w, slope));
}

// Asynchronous global -> shared copies (cp.async; the copy completes at
// cp_wait) of 4 or 16 bytes.
__device__ __forceinline__ void cp4(float* s, const float* g) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
#else
  *s = *g;
#endif
}

__device__ __forceinline__ void cp16(float* s, const float* g) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
#else
  st4(s, ld4(g));
#endif
}

__device__ __forceinline__ void cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int N>
__device__ __forceinline__ void cp_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// ---------------------------------------------------------------------------
// the live-job list
// ---------------------------------------------------------------------------

// counts[block] = the jobs of this block of LIST_THREADS with a valid node
__global__ void live_count_kernel(const uint8_t* __restrict__ node_mask,
                                  int S, int J, int* __restrict__ counts) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  int live = 0;
  if (j < J) {
    const uint8_t* mr = node_mask + (long)j * S;
    for (int s = 0; s < S; ++s) live |= mr[s];
  }
  const int c = __syncthreads_count(live != 0);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// live[slot] = (job, node_mask bits, edgeless, 0) for the live jobs in job
// order; *n_live = their number (written by the last block)
__global__ void live_list_kernel(const uint8_t* __restrict__ node_mask,
                                 const uint8_t* __restrict__ edgeless, int S,
                                 int K, int J, const int* __restrict__ counts,
                                 int4* __restrict__ live,
                                 int* __restrict__ n_live) {
  int* wsum = reinterpret_cast<int*>(sm);  // [33]
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int nw = blockDim.x >> 5;
  int part = 0;
  for (int b = t; b < (int)blockIdx.x; b += blockDim.x) part += counts[b];
  for (int o = 16; o; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
  if (lane == 0) wsum[wid] = part;
  __syncthreads();
  if (t == 0) {
    int off = 0;
    for (int w = 0; w < nw; ++w) off += wsum[w];
    wsum[32] = off;
  }
  __syncthreads();
  const int off = wsum[32];
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + t;
  unsigned V = 0;
  if (j < J) {
    const uint8_t* mr = node_mask + (long)j * S;
    for (int s = 0; s < S; ++s) V |= (mr[s] ? 1u : 0u) << s;
  }
  const unsigned bal = __ballot_sync(FULL, V != 0);
  if (lane == 0) wsum[wid] = __popc(bal);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < nw; ++w) {
    if (w < wid) before += wsum[w];
    total += wsum[w];
  }
  if (V != 0)
    live[off + before + __popc(bal & ((1u << lane) - 1u))] =
        make_int4(j, (int)V, edgeless[j / K] ? 1 : 0, 0);
  if (blockIdx.x == gridDim.x - 1 && t == 0) *n_live = off + total;
}

// ---------------------------------------------------------------------------
// a warp's passes over one job
// ---------------------------------------------------------------------------

// MLP m over the S rows of a job. A lane computes 4 x 4 tiles of a
// layer's output (rows rg, rg + R4, rg + 2 R4, rg + 3 R4 with R4 = S / 4
// rounded up, outputs 4 og .. 4 og + 3), 16 FMAs per 16-byte load of 4
// inputs of each row and of 4 weight rows: interleaved rows keep the row
// loads of a quarter-warp on distinct banks. Layer l's hidden
// pre-activations go to Z[r * Hp + hoff[l] + o] (padding columns written
// 0) and, when `save` is given, to the same place there; the output to
// out[r * Dp + o] unless out is null. Layer 0 reads in[r * is + k] for k <
// in4 (zero-padded), as 0 on the rows of `zrows`.
__device__ __noinline__ void rows_fwd(const float* W, const Mlp& m,
                                      const float* in, int is,
                                      unsigned zrows, float* Z, int Hp,
                                      float* out, int Dp, float* save, int S,
                                      float slope, int lane) {
  const int R4 = (S + 3) >> 2;
  for (int l = 0; l < m.n; ++l) {
    const int ni4 = m.in4[l], no = m.out[l], no4 = (no + 3) & ~3;
    const int rs = m.rs[l];
    const float* Wt = W + m.off[l];
    const float* b = Wt + ni4 * rs;
    const bool last = l == m.n - 1;
    if (last && !out) break;
    if (l > 0) __syncwarp();
    const float* ain = l == 0 ? in : Z + m.hoff[l - 1];
    const int as = l == 0 ? is : Hp;
    const int O4 = no4 >> 2;
    const float sl = l == 0 ? 1.f : slope;  // act(v, 1) = v: layer 0 raw
    float* zdst = Z + m.hoff[l];
    float* sdst = save ? save + m.hoff[l] : nullptr;
    for (int t = lane; t < R4 * O4; t += 32) {
      const int rg = t / O4, o = 4 * (t - rg * O4);
      float acc[4][4];
      const float4 bv = ld4(b + o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = bv.x;
        acc[i][1] = bv.y;
        acc[i][2] = bv.z;
        acc[i][3] = bv.w;
      }
      bool live[4];
      const float* arow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + i * R4;
        live[i] = r < S && !(l == 0 && ((zrows >> r) & 1u));
        arow[i] = ain + (r < S ? r : S - 1) * as;  // loaded, then zeroed
      }
      for (int k = 0; k < ni4; k += 4) {
        float av[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4 v = act4(ld4(arow[i] + k), sl);
          if (!live[i]) v = make_float4(0.f, 0.f, 0.f, 0.f);
          av[i][0] = v.x;
          av[i][1] = v.y;
          av[i][2] = v.z;
          av[i][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w = ld4(Wt + (k + kk) * rs + o);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(av[i][kk], w.x, acc[i][0]);
            acc[i][1] = fmaf(av[i][kk], w.y, acc[i][1]);
            acc[i][2] = fmaf(av[i][kk], w.z, acc[i][2]);
            acc[i][3] = fmaf(av[i][kk], w.w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + i * R4;
        if (r >= S) continue;
        if (last) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (o + j < no) out[r * Dp + o + j] = acc[i][j];
        } else {
          const float4 v = make_float4(
              o < no ? acc[i][0] : 0.f, o + 1 < no ? acc[i][1] : 0.f,
              o + 2 < no ? acc[i][2] : 0.f, o + 3 < no ? acc[i][3] : 0.f);
          st4(zdst + r * Hp + o, v);
          if (sdst) st4(sdst + r * Hp + o, v);
        }
      }
    }
  }
  __syncwarp();
}

// A level step's rows (plist[0..np)): MLP m, the warp's lanes over (row,
// output). Layer 0 reads in[p * is + k]; hidden pre-activations go to
// Z[p * Hp + hoff[l] + o] and to the node's record row; the input is
// recorded too; the output goes to out[p * Dp + o] (plus add[p * Dp + o]
// when given).
__device__ __noinline__ void level_fwd(const float* W, const Mlp& m, const float* in,
                          int is, const int* plist, int np, float* Z, int Hp,
                          float* out, const float* add, int Dp, float* rec,
                          int RS, float slope, int lane) {
  const int ni4 = m.in4[0];
  for (int i = lane; i < np * ni4; i += 32) {
    const int pi = i / ni4, k = i - pi * ni4, p = plist[pi];
    rec[p * RS + k] = in[p * is + k];
  }
  for (int l = 0; l < m.n; ++l) {
    const int ni = m.in[l], no = m.out[l], no4 = (no + 3) & ~3;
    const int rs = m.rs[l];
    const float* Wt = W + m.off[l];
    const float* b = Wt + m.in4[l] * rs;
    const bool last = l == m.n - 1;
    const float sl = l == 0 ? 1.f : slope;  // act(v, 1) = v: layer 0 raw
    for (int i = lane; i < np * no4; i += 32) {
      const int pi = i / no4, o = i - pi * no4, p = plist[pi];
      float v = 0.f;
      if (o < no) {
        const float* a = l == 0 ? in + p * is : Z + p * Hp + m.hoff[l - 1];
        const float* wc = Wt + o;
        float acc = b[o];
#pragma unroll 4
        for (int k = 0; k < ni; ++k) acc = fmaf(act(a[k], sl), wc[k * rs], acc);
        v = acc;
      }
      if (last) {
        if (o < no) out[p * Dp + o] = add ? add[p * Dp + o] + v : v;
      } else {
        Z[p * Hp + m.hoff[l] + o] = v;
        rec[p * RS + m.rz[l] + o] = v;
      }
    }
    __syncwarp();
  }
}

// The backward of a level step's MLP m on the rows of plist, given the
// output gradient rows dout[p * Dp + o]: the lanes over (row, input) of
// each layer; deltas to the record rows (and the hidden ones to Z[p]); the
// input gradient to gin[p * gs + k] (added when gadd).
__device__ __noinline__ void level_bwd(const float* W, const Mlp& m, const float* dout,
                          int Dp, const int* plist, int np, float* Z, int Hp,
                          float* gin, int gs, bool gadd, float* rec, int RS,
                          float slope, int lane) {
  for (int l = m.n - 1; l >= 0; --l) {
    const int no4 = (m.out[l] + 3) & ~3, ni = m.in[l], ni4 = m.in4[l];
    const int rs = m.rs[l];
    const float* Wt = W + m.off[l];
    const bool last = l == m.n - 1;
    for (int i = lane; i < np * no4; i += 32) {
      const int pi = i / no4, o = i - pi * no4, p = plist[pi];
      rec[p * RS + m.rd[l] + o] =
          last ? dout[p * Dp + o] : Z[p * Hp + m.hoff[l] + o];
    }
    for (int i = lane; i < np * ni4; i += 32) {
      const int pi = i / ni4, k = i - pi * ni4, p = plist[pi];
      const float* dr = last ? dout + p * Dp : Z + p * Hp + m.hoff[l];
      // the pre-activation (its record) is loaded before the dot product
      const float z = l > 0 && k < ni ? rec[p * RS + m.rz[l - 1] + k] : 0.f;
      float v = 0.f;
      if (k < ni) {
        const float* wr = Wt + k * rs;
#pragma unroll 4
        for (int o = 0; o < no4; o += 4) {
          const float4 dv = ld4(dr + o), w = ld4(wr + o);
          v = fmaf(dv.x, w.x, v);
          v = fmaf(dv.y, w.y, v);
          v = fmaf(dv.z, w.z, v);
          v = fmaf(dv.w, w.w, v);
        }
      }
      if (l > 0) {
        Z[p * Hp + m.hoff[l - 1] + k] = k < ni ? v * dact(z, slope) : 0.f;
      } else if (k < ni) {
        gin[p * gs + k] = gadd ? gin[p * gs + k] + v : v;
      }
    }
    __syncwarp();
  }
}

// Layer l's weight gradient of MLP m over a job's rows, added to the
// warp's accumulator `acc` (padded layout): the S rows of the row pass
// (the input a_l: layer 0 `in` (0 on the rows of za), else act of Z's
// hidden l-1; the delta: the last layer `dout` (0 on the rows of zd), else
// Z's hidden l), then the recorded level rows of `lr` in node order (rec
// rows at mo). A lane per 4 x 4 tile of W^T; the tiles of the first four
// inputs also sum the bias.
__device__ __forceinline__ void dw_sweep(const Mlp& m, int l, const float* in, int is,
                         unsigned za, const float* dout, int Dp, unsigned zd,
                         const float* Z, int Hp, unsigned lr, const float* rec,
                         int RS, int mo, float* acc, int S, float slope,
                         int lane) {
  // the layer's table entries, read once
  const int kt = m.in4[l] >> 2, ot = ((m.out[l] + 3) & ~3) >> 2;
  const int rs = m.rs[l], woff = m.off[l], in4 = m.in4[l];
  const bool first = l == 0, last = l == m.n - 1;
  const int ra = first ? 0 : m.rz[l - 1], rd = m.rd[l];  // record offsets
  // the dense rows: a_l at abase + r * as (act applied unless layer 0),
  // delta_l at dbase + r * dstr
  const float* abase = first ? in : Z + m.hoff[l - 1];
  const int as = first ? is : Hp;
  const float* dbase = last ? dout : Z + m.hoff[l];
  const int dstr = last ? Dp : Hp;
  const unsigned zrows_a = first ? za : 0u, zrows_d = last ? zd : 0u;
  const float sl_a = first ? 1.f : slope;  // act(v) = v >= 0 ? v : sl_a v
  for (int t = lane; t < kt * ot; t += 32) {
    const int kb = t / ot, ob = t - kb * ot;
    // the accumulator's tile, loaded first so the loads overlap the sums
    float* g = acc + woff + 4 * kb * rs + 4 * ob;
    float* gb = acc + woff + in4 * rs + 4 * ob;
    float4 old[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) old[i] = ld4(g + i * rs);
    const float4 oldb = kb == 0 ? ld4(gb) : make_float4(0.f, 0.f, 0.f, 0.f);
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    float4 bs = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* ap = abase + 4 * kb;
    const float* dp = dbase + 4 * ob;
#pragma unroll 2
    for (int r = 0; r < S; ++r) {
      float4 av = ld4(ap + r * as), dv = ld4(dp + r * dstr);
      if ((zrows_a >> r) & 1u) av = make_float4(0.f, 0.f, 0.f, 0.f);
      if ((zrows_d >> r) & 1u) dv = make_float4(0.f, 0.f, 0.f, 0.f);
      av = act4(av, sl_a);
      const float a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(a[i], dv.x, s[i][0]);
        s[i][1] = fmaf(a[i], dv.y, s[i][1]);
        s[i][2] = fmaf(a[i], dv.z, s[i][2]);
        s[i][3] = fmaf(a[i], dv.w, s[i][3]);
      }
      bs.x += dv.x;
      bs.y += dv.y;
      bs.z += dv.z;
      bs.w += dv.w;
    }
    const float* rr0 = rec + mo + ra + 4 * kb;  // a_0 at 0, else z_{l-1}
    const float* rd0 = rec + mo + rd + 4 * ob;
    for (unsigned bits = lr; bits; bits &= bits - 1u) {
      const int p = __ffs(bits) - 1;
      const float4 av = act4(ld4(rr0 + p * RS), sl_a);
      const float4 dv = ld4(rd0 + p * RS);
      const float a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(a[i], dv.x, s[i][0]);
        s[i][1] = fmaf(a[i], dv.y, s[i][1]);
        s[i][2] = fmaf(a[i], dv.z, s[i][2]);
        s[i][3] = fmaf(a[i], dv.w, s[i][3]);
      }
      bs.x += dv.x;
      bs.y += dv.y;
      bs.z += dv.z;
      bs.w += dv.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(g + i * rs, make_float4(old[i].x + s[i][0], old[i].y + s[i][1],
                                  old[i].z + s[i][2], old[i].w + s[i][3]));
    if (kb == 0)
      st4(gb, make_float4(oldb.x + bs.x, oldb.y + bs.y, oldb.z + bs.z,
                          oldb.w + bs.w));
  }
}

// What the input gradient of a row pass's first layer does.
enum { GIN_NONE = 0, GIN_MSG = 1, GIN_UPD = 2 };

// The backward of MLP m's row pass (Z holds its hidden pre-activations,
// recomputed by rows_fwd): per layer from the last, the weight gradient
// over the S rows and the level rows `lr` (dw_sweep), then, a lane per
// row, the previous layer's delta (into Z, over the pre-activations) or,
// at layer 0, the input gradient: GIN_MSG adds it into gh on the rows
// without a child (the h0 of a node with one is 0: its gradient stops);
// GIN_UPD writes hin = (gh on U's rows) + it, the gradient of h_init.
__device__ __noinline__ void rows_bwd(const float* W, const Mlp& m, const float* in,
                         int is, unsigned za, const float* dout, unsigned zd,
                         float* Z, int Hp, int Dp, unsigned lr,
                         const float* rec, int RS, int mo, float* acc,
                         int mode, float* gh, float* hin, unsigned HC,
                         unsigned U, int S, float slope, int lane) {
  for (int l = m.n - 1; l >= 0; --l) {
    __syncwarp();
    dw_sweep(m, l, in, is, za, dout, Dp, zd, Z, Hp, lr, rec, RS, mo, acc, S,
             slope, lane);
    __syncwarp();
    if (l == 0 && mode == GIN_NONE) continue;
    // a lane per 4 x 4 tile (rows rg + i R4, inputs 4 kg + j): the
    // previous layer's delta, or the input gradient
    const int ni = m.in[l], ni4 = m.in4[l], no4 = (m.out[l] + 3) & ~3;
    const int rs = m.rs[l];
    const float* Wt = W + m.off[l];
    const bool last = l == m.n - 1;
    const float* dsrc = last ? dout : Z + m.hoff[l];
    const int ds = last ? Dp : Hp;
    const int R4 = (S + 3) >> 2, K4 = ni4 >> 2;
    for (int t = lane; t < R4 * K4; t += 32) {
      const int kg = t / R4, rg = t - kg * R4, k0 = 4 * kg;
      bool live[4];
      const float* drow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + i * R4;
        live[i] = r < S && !(last && ((zd >> r) & 1u));
        drow[i] = dsrc + (r < S ? r : S - 1) * ds;  // loaded, then zeroed
      }
      float sum[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[i][j] = 0.f;
      for (int o = 0; o < no4; o += 4) {
        float4 dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i] = ld4(drow[i] + o);
          if (!live[i]) dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w = ld4(Wt + (k0 + j) * rs + o);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sum[i][j] = fmaf(dv[i].x, w.x, sum[i][j]);
            sum[i][j] = fmaf(dv[i].y, w.y, sum[i][j]);
            sum[i][j] = fmaf(dv[i].z, w.z, sum[i][j]);
            sum[i][j] = fmaf(dv[i].w, w.w, sum[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + i * R4;
        if (r >= S) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + j;
          if (l > 0) {
            float* z = Z + r * Hp + m.hoff[l - 1] + k;
            *z = k < ni ? sum[i][j] * dact(*z, slope) : 0.f;
          } else if (k < ni) {
            if (mode == GIN_MSG) {
              if (!((HC >> r) & 1u)) gh[r * Dp + k] += sum[i][j];
            } else {
              hin[r * Dp + k] =
                  (((U >> r) & 1u) ? gh[r * Dp + k] : 0.f) + sum[i][j];
            }
          }
        }
      }
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// the backward kernel
// ---------------------------------------------------------------------------

// The padded weight layout's float e, from the packed weights.
__device__ float padded_weight(const float* packed, const Dims& d, int e) {
  const Mlp* ms[3] = {&d.prep, &d.msg, &d.upd};
  for (int q = 0; q < 3; ++q) {
    const Mlp& m = *ms[q];
    for (int l = 0; l < m.n; ++l) {
      const int rs = m.rs[l], len = m.in4[l] * rs + rs;
      const int j = e - m.off[l];
      if (j < 0 || j >= len) continue;
      const int ni = m.in[l], no = m.out[l];
      if (j < m.in4[l] * rs) {
        const int k = j / rs, o = j - k * rs;
        return k < ni && o < no ? packed[m.poff[l] + k * no + o] : 0.f;
      }
      const int o = j - m.in4[l] * rs;
      return o < no ? packed[m.poff[l] + ni * no + o] : 0.f;
    }
  }
  return 0.f;
}

// The packed gradient's float i as a padded offset (-1: padding).
__device__ int padded_index(const Dims& d, int i) {
  const Mlp* ms[3] = {&d.prep, &d.msg, &d.upd};
  for (int q = 0; q < 3; ++q) {
    const Mlp& m = *ms[q];
    for (int l = 0; l < m.n; ++l) {
      const int ni = m.in[l], no = m.out[l];
      const int j = i - m.poff[l];
      if (j < 0 || j >= ni * no + no) continue;
      if (j < ni * no) {
        const int k = j / no;
        return m.off[l] + k * m.rs[l] + (j - k * no);
      }
      return m.off[l] + m.in4[l] * m.rs[l] + (j - ni * no);
    }
  }
  return -1;
}

__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
decima_node_encoder_bwd_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ adj,
    const int32_t* __restrict__ level, const float* __restrict__ weights,
    const float* __restrict__ grad_out, const int4* __restrict__ live,
    const int* __restrict__ n_live, float* __restrict__ acc_all,
    float* __restrict__ rec_all, float* __restrict__ zs_all, Dims d0) {
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int S = d0.S, F = d0.F, D = d0.D, Dp = d0.Dp, Hp = d0.Hp;
  const int Fp = d0.Fp;
  // the layer table in shared memory: the passes (one copy of each in the
  // binary, called) read it there
  Dims& d = *reinterpret_cast<Dims*>(sm);
  if (t == 0) d = d0;
  float* W = sm + DIMS_FLOATS;
  for (int e = t; e < d0.wtot + SLACK; e += blockDim.x)
    W[e] = e < d0.wtot ? padded_weight(weights, d0, e) : 0.f;
  float* regions = W + d0.wtot + SLACK;
  for (int e = t; e < d0.wpb * d0.warp_floats; e += blockDim.x) regions[e] = 0.f;
  __syncthreads();

  const int gw = blockIdx.x * d0.wpb + wid;
  const int n = *n_live;
  if (gw >= n) return;
  float* hin = regions + wid * d0.warp_floats;  // h_init, later its gradient
  float* hv = hin + S * Dp;   // h0; a level node's aggregation, then h_fin
  float* mb = hv + S * Dp;    // the current messages, later their gradients
  float* gh = mb + S * Dp;    // dL/dh: h_fin's gradient on U, else h0's
  float* Z = gh + S * Dp;     // an MLP's hidden pre-activations or deltas
  float* xb = Z + S * Hp;     // x of this job and of the next: 2 x [S, Fp]
  int* rows = reinterpret_cast<int*>(xb + 2 * S * Fp);  // children masks
  int* plist = rows + 32;     // a level step's nodes
  int* clist = plist + 32;    // their children
  float* acc = acc_all + (long)gw * d0.wtot;
  float* rec = rec_all + (long)gw * S * d0.RS;
  // the row passes' hidden pre-activations (prep, update, msg), saved in
  // the forward and copied back into Z for their backward
  float* zs = zs_all + (long)gw * 3 * S * Hp;
  auto restore = [&](const float* src) {
    for (int i = lane; i < S * (Hp >> 2); i += 32) cp16(Z + 4 * i, src + 4 * i);
    cp_commit();
    cp_wait<0>();
    __syncwarp();
  };
  const int mo_msg = d.upd.rlen;
  for (int e = 4 * lane; e < d0.wtot; e += 128)
    st4(acc + e, make_float4(0.f, 0.f, 0.f, 0.f));
  __syncwarp();

  // the next job's inputs: x by cp.async, adjacency words and level into
  // registers (consumed a job later)
  const int aw = S >> 2;
  auto fetch = [&](int job, float* xdst, unsigned (&raw)[8], int& lv) {
    const float* xj = x + (long)job * S * F;
    if (d0.x16) {
      const int c4 = F >> 2;
      for (int i = lane; i < S * c4; i += 32) {
        const int r = i / c4, c = i - r * c4;
        cp16(xdst + r * Fp + 4 * c, xj + r * F + 4 * c);
      }
    } else {
      for (int i = lane; i < S * F; i += 32) {
        const int r = i / F;
        cp4(xdst + r * Fp + (i - r * F), xj + i);
      }
    }
    lv = lane < S ? level[(long)job * S + lane] : -1;
    if (d0.adjw && lane < S) {
      const unsigned* ar = reinterpret_cast<const unsigned*>(
          adj + ((long)job * S + lane) * S);
#pragma unroll
      for (int w = 0; w < 8; ++w) raw[w] = w < aw ? ar[w] : 0u;
    }
  };

  int slot = gw, par = 0;
  int4 h = live[slot];
  unsigned raw[8];
  int lv;
  fetch(h.x, xb, raw, lv);
  cp_commit();
  for (;;) {
    cp_wait<0>();
    __syncwarp();
    const int job = h.x;
    const unsigned V = (unsigned)h.y;
    const bool el = h.z != 0;
    // this job's dL/dh, needed after the forward
    const float* gj = grad_out + (long)job * S * D;
    if (d0.g16) {
      const int c4 = D >> 2;
      for (int i = lane; i < S * c4; i += 32) {
        const int r = i / c4, c = i - r * c4;
        cp16(gh + r * Dp + 4 * c, gj + r * D + 4 * c);
      }
    } else {
      for (int i = lane; i < S * D; i += 32) {
        const int r = i / D;
        cp4(gh + r * Dp + (i - r * D), gj + i);
      }
    }
    cp_commit();
    unsigned row = 0;
    if (lane < S) {
      if (d0.adjw) {
#pragma unroll
        for (int w = 0; w < 8; ++w)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (w < aw) row |= (((raw[w] >> (8 * b)) & 0xffu) ? 1u : 0u)
                               << (4 * w + b);
      } else {
        const uint8_t* ar = adj + ((long)job * S + lane) * S;
        for (int c = 0; c < S; ++c) row |= (ar[c] ? 1u : 0u) << c;
      }
    }
    const int my_lv = lv;
    const int ns = slot + d0.W;
    int4 hn = h;
    if (ns < n) {
      hn = live[ns];
      fetch(hn.x, xb + (par ^ 1) * S * Fp, raw, lv);
    }
    cp_commit();
    float* xs = xb + par * S * Fp;
    rows[lane] = (int)row;
    const bool hc = row != 0u;
    const bool u = hc && my_lv >= 0 && my_lv < d0.nl;
    const unsigned HC = __ballot_sync(FULL, hc);
    const unsigned U = __ballot_sync(FULL, u);
    const unsigned M1 = __ballot_sync(FULL, u && my_lv >= 1);
    __syncwarp();

    rows_fwd(W, d.prep, xs, Fp, 0u, Z, Hp, hin, Dp, zs, S, d0.slope, lane);
    if (el) {  // out = where(V, h_init, 0): prep alone carries the gradient
      cp_wait<1>();
      __syncwarp();
      if (lane < S && !((V >> lane) & 1u))
        for (int k = 0; k < D; ++k) gh[lane * Dp + k] = 0.f;
      rows_bwd(W, d.prep, xs, Fp, 0u, gh, 0u, Z, Hp, Dp, 0u, rec, d0.RS, 0,
               acc + 0, GIN_NONE, gh, hin, HC, U, S, d0.slope, lane);
    } else {
      // ---- forward: h0, msg(h0), then the level steps deepest first ----
      rows_fwd(W, d.upd, hin, Dp, 0u, Z, Hp, hv, Dp, zs + S * Hp, S,
               d0.slope, lane);
      if (hc)
        for (int k = 0; k < D; ++k) hv[lane * Dp + k] = 0.f;
      __syncwarp();
      rows_fwd(W, d.msg, hv, Dp, 0u, Z, Hp, mb, Dp, zs + 2 * S * Hp, S,
               d0.slope, lane);
      __syncwarp();
      float* agg = d0.aggz >= 0 ? Z + d0.aggz : hv;  // a level node's row
      const int as = d0.aggz >= 0 ? Hp : Dp;
      const int D4 = (D + 3) & ~3;
      unsigned rem = U;
      while (rem) {
        const bool mine = (rem >> lane) & 1u;
        const int lvl = __reduce_max_sync(FULL, mine ? my_lv : -1);
        const unsigned P = __ballot_sync(FULL, mine && my_lv == lvl);
        rem &= ~P;
        if ((P >> lane) & 1u) plist[__popc(P & ((1u << lane) - 1u))] = lane;
        __syncwarp();
        const int np = __popc(P);
        for (int i = lane; i < np * D4; i += 32) {  // agg = adj @ msg(h)
          const int pi = i / D4, k = i - pi * D4, p = plist[pi];
          float s = 0.f;
          if (k < D)
            for (unsigned bits = (unsigned)rows[p]; bits; bits &= bits - 1u)
              s += mb[(__ffs(bits) - 1) * Dp + k];
          agg[p * as + k] = s;
        }
        __syncwarp();
        level_fwd(W, d.upd, agg, as, plist, np, Z, Hp, hv, hin, Dp, rec,
                  d0.RS, d0.slope, lane);
        if (lvl >= 1)
          level_fwd(W, d.msg, hv, Dp, plist, np, Z, Hp, mb, nullptr, Dp,
                    rec + mo_msg, d0.RS, d0.slope, lane);
      }
      // ---- backward: the output, then the levels in reverse order ----
      cp_wait<1>();
      __syncwarp();
      if (lane < S) {
        const bool v = (V >> lane) & 1u;
        for (int k = 0; k < D; ++k) {
          if (!v) gh[lane * Dp + k] = 0.f;
          mb[lane * Dp + k] = 0.f;
        }
      }
      __syncwarp();
      rem = U;
      while (rem) {
        const bool mine = (rem >> lane) & 1u;
        const int lvl = __reduce_min_sync(FULL, mine ? my_lv : 0x7fffffff);
        const unsigned P = __ballot_sync(FULL, mine && my_lv == lvl);
        rem &= ~P;
        if ((P >> lane) & 1u) plist[__popc(P & ((1u << lane) - 1u))] = lane;
        __syncwarp();
        const int np = __popc(P);
        if (lvl >= 1) {
          // msg(h_fin) of P: every reader sits at a lower level, done already
          level_bwd(W, d.msg, mb, Dp, plist, np, Z, Hp, gh, Dp, true,
                    rec + mo_msg, d0.RS, d0.slope, lane);
          for (int i = lane; i < np * D; i += 32) {  // now msg(h0)'s gradient
            const int pi = i / D;
            mb[plist[pi] * Dp + (i - pi * D)] = 0.f;
          }
          __syncwarp();
        }
        // h_fin = h_init + update(agg): the aggregation's gradient
        level_bwd(W, d.upd, gh, Dp, plist, np, Z, Hp, agg, as, false, rec,
                  d0.RS, d0.slope, lane);
        // scatter it along the edges into the messages each child sent
        unsigned C = 0;
        for (int pi = 0; pi < np; ++pi) C |= (unsigned)rows[plist[pi]];
        if ((C >> lane) & 1u) clist[__popc(C & ((1u << lane) - 1u))] = lane;
        __syncwarp();
        const int nc = __popc(C);
        for (int i = lane; i < nc * D; i += 32) {
          const int ci = i / D, k = i - ci * D, c = clist[ci];
          float s = 0.f;
          for (int pi = 0; pi < np; ++pi) {
            const int p = plist[pi];
            if (((unsigned)rows[p] >> c) & 1u) s += agg[p * as + k];
          }
          mb[c * Dp + k] += s;
        }
        __syncwarp();
      }
      // msg(h0) over every row, then h0 = where(has_child, 0, update(h_init)),
      // each on its pre-activations saved in the forward
      restore(zs + 2 * S * Hp);
      rows_bwd(W, d.msg, hv, Dp, HC, mb, 0u, Z, Hp, Dp, M1, rec, d0.RS, mo_msg,
               acc, GIN_MSG, gh, hin, HC, U, S, d0.slope, lane);
      restore(zs + S * Hp);
      rows_bwd(W, d.upd, hin, Dp, 0u, gh, HC, Z, Hp, Dp, U, rec, d0.RS, 0, acc,
               GIN_UPD, gh, hin, HC, U, S, d0.slope, lane);
      restore(zs);
      rows_bwd(W, d.prep, xs, Fp, 0u, hin, 0u, Z, Hp, Dp, 0u, rec, d0.RS, 0,
               acc, GIN_NONE, gh, hin, HC, U, S, d0.slope, lane);
    }
    if (ns >= n) break;
    slot = ns;
    h = hn;
    par ^= 1;
  }
  cp_wait<0>();
}

// partial[g][e] = the sum over the warps of group g (GROUP_WARPS of them,
// those that had a job), in warp order, of acc[w][e]
__global__ void reduce_warps_kernel(const float* __restrict__ acc_all,
                                    const int* __restrict__ n_live, int W,
                                    int WP, int G,
                                    float* __restrict__ partial) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)G * WP) return;
  const int g = (int)(i / WP), e = (int)(i - (long)g * WP);
  const int wn = min(W, *n_live);
  const int w1 = min(wn, (g + 1) * GROUP_WARPS);
  float s = 0.f;
  for (int w = g * GROUP_WARPS; w < w1; ++w) s += acc_all[(long)w * WP + e];
  partial[i] = s;
}

// grad[i] (packed layout) = the sum over the groups, in group order
__global__ void reduce_groups_kernel(const float* __restrict__ partial,
                                     Dims d, float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d.ptot) return;
  const int e = padded_index(d, i);
  float s = 0.f;
  if (e >= 0)
    for (int g = 0; g < d.G; ++g) s += partial[(long)g * d.wtot + e];
  grad[i] = s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static int pad4(int w) { return (w + 3) & ~3; }

// w rounded up to 4, plus 4 when that is 0 mod 8: rows at that stride are
// read 16 bytes a lane without bank conflicts
static int stride4(int w) {
  const int p = pad4(w);
  return ((p >> 2) & 1) ? p : p + 4;
}

static int fill_mlp(Mlp* m, const int* spec, int* poff, int* off, int* hid) {
  // spec: n, in[0..n-1], out[0..n-1]
  m->n = spec[0];
  if (m->n < 1 || m->n > MAX_LAYERS) return -1;
  int h = 0;
  for (int l = 0; l < m->n; ++l) {
    m->in[l] = spec[1 + l];
    m->out[l] = spec[1 + m->n + l];
    if (m->in[l] < 1 || m->out[l] < 1 || m->in[l] > MAX_WIDTH ||
        m->out[l] > MAX_WIDTH)
      return -1;
    if (l > 0 && m->in[l] != m->out[l - 1]) return -1;
    m->in4[l] = pad4(m->in[l]);
    m->rs[l] = stride4(m->out[l]);
    m->poff[l] = *poff;
    *poff += m->in[l] * m->out[l] + m->out[l];
    m->off[l] = *off;
    *off += m->in4[l] * m->rs[l] + m->rs[l];
    m->hoff[l] = h;
    if (l < m->n - 1) h += pad4(m->out[l]);
  }
  int r = m->in4[0];
  for (int l = 0; l < m->n - 1; ++l) {
    m->rz[l] = r;
    r += pad4(m->out[l]);
  }
  for (int l = 0; l < m->n; ++l) {
    m->rd[l] = r;
    r += pad4(m->out[l]);
  }
  m->rlen = r;
  if (h > *hid) *hid = h;
  return 1 + 2 * m->n;
}

struct Plan {
  Dims d;
  int blocks, list_blocks;
  size_t smem;
  // scratch byte offsets
  size_t o_counts, o_nlive, o_live, o_acc, o_rec, o_zs, o_part, bytes;
};

static size_t up16(size_t b) { return (b + 15) & ~(size_t)15; }

static int make_plan(Plan* P, int B, int K, int S, int F, int D, int nl,
                     float slope, const int* spec, int sms) {
  Dims& d = P->d;
  int poff = 0, off = 0, hid = 0;
  const int* p = spec;
  int used = fill_mlp(&d.prep, p, &poff, &off, &hid);
  if (used < 0) return -1;
  p += used;
  used = fill_mlp(&d.msg, p, &poff, &off, &hid);
  if (used < 0) return -1;
  p += used;
  used = fill_mlp(&d.upd, p, &poff, &off, &hid);
  if (used < 0) return -1;
  if (S < 1 || S > 32 || F < 1 || D < 1 || B < 0 || K < 0 || sms < 1 ||
      (long)B * K > 0x7fffffffL)
    return -1;
  if (d.prep.in[0] != F || d.prep.out[d.prep.n - 1] != D ||
      d.msg.in[0] != D || d.msg.out[d.msg.n - 1] != D ||
      d.upd.in[0] != D || d.upd.out[d.upd.n - 1] != D)
    return -1;
  d.S = S; d.F = F; d.D = D; d.nl = nl; d.K = K; d.slope = slope;
  d.J = B * K;
  d.wtot = off;
  d.ptot = (poff + 3) / 4 * 4;
  d.Fp = stride4(F);
  d.Dp = stride4(D);
  d.aggz = d.upd.n == 1 ? hid : -1;
  d.Hp = stride4(hid + (d.upd.n == 1 ? pad4(D) : 0));
  d.RS = d.upd.rlen + d.msg.rlen;
  d.warp_floats = pad4(4 * S * d.Dp + S * d.Hp + 2 * S * d.Fp + 96);
  const long room = SMEM_MAX / 4 - DIMS_FLOATS - d.wtot - SLACK;
  const long fit = room / d.warp_floats;
  if (fit < 1) return -1;
  d.wpb = fit < MAX_WARPS ? (int)fit : MAX_WARPS;
  const long jobs_blocks = ((long)d.J + d.wpb - 1) / d.wpb;
  P->blocks = (int)(jobs_blocks < sms ? jobs_blocks : sms);
  d.W = P->blocks * d.wpb;
  d.G = d.W > 0 ? (d.W + GROUP_WARPS - 1) / GROUP_WARPS : 1;
  d.x16 = d.g16 = d.adjw = 0;
  P->list_blocks = (d.J + LIST_THREADS - 1) / LIST_THREADS;
  P->smem = sizeof(float) * ((size_t)DIMS_FLOATS + d.wtot + SLACK +
                             (size_t)d.wpb * d.warp_floats);
  size_t o = 0;
  P->o_counts = o; o = up16(o + sizeof(int) * (size_t)P->list_blocks);
  P->o_nlive = o;  o = up16(o + sizeof(int));
  P->o_live = o;   o = up16(o + sizeof(int4) * (size_t)d.J);
  P->o_acc = o;    o = up16(o + sizeof(float) * (size_t)d.W * d.wtot);
  P->o_rec = o;    o = up16(o + sizeof(float) * (size_t)d.W * S * d.RS);
  P->o_zs = o;     o = up16(o + sizeof(float) * (size_t)d.W * 3 * S * d.Hp);
  P->o_part = o;   o = up16(o + sizeof(float) * (size_t)d.G * d.wtot);
  P->bytes = o;
  return 0;
}

// Scratch bytes a call with these dims needs (0 on success, -1 for dims the
// kernel does not take). `sms`: the card's multiprocessors.
extern "C" int decima_node_encoder_bwd_scratch(int B, int K, int S, int F,
                                               int D, const int* mlp_spec,
                                               int sms, long long* bytes) {
  Plan P;
  if (make_plan(&P, B, K, S, F, D, 1, 0.f, mlp_spec, sms) != 0) return -1;
  *bytes = (long long)P.bytes;
  return 0;
}

// C entry point. Inputs as the forward's (`decima_node_encoder_launch`):
// x f32[B,K,S,F], adj u8[B,K,S,S], level i32[B,K,S], node_mask u8[B,K,S],
// edgeless u8[B], the packed weights, `mlp_spec`; grad_out f32[B,K,S,D].
// `scratch` holds `scratch_bytes` (at least what
// decima_node_encoder_bwd_scratch gives); `grad` receives the gradient in
// the packed layout (the packed length rounded up to 4). Launches the
// live-list kernels, the backward (one block per SM, at most `sms`) and the
// two reductions. Returns cudaGetLastError() after the launches (0 on
// success), or -1 for dims the kernel does not take.
extern "C" int decima_node_encoder_bwd_launch(
    const float* x, const uint8_t* adj, const int32_t* level,
    const uint8_t* node_mask, const uint8_t* edgeless, const float* weights,
    const float* grad_out, void* scratch, long long scratch_bytes,
    float* grad, int B, int K, int S, int F, int D, int nl, float slope,
    const int* mlp_spec, int sms, void* stream) {
  Plan P;
  if (make_plan(&P, B, K, S, F, D, nl, slope, mlp_spec, sms) != 0) return -1;
  if (scratch_bytes < (long long)P.bytes) return -1;
  Dims& d = P.d;
  d.x16 = (F % 4 == 0) && ((uintptr_t)x % 16 == 0);
  d.g16 = (D % 4 == 0) && ((uintptr_t)grad_out % 16 == 0);
  d.adjw = (S % 4 == 0) && ((uintptr_t)adj % 4 == 0);
  char* sc = static_cast<char*>(scratch);
  int* counts = reinterpret_cast<int*>(sc + P.o_counts);
  int* n_live = reinterpret_cast<int*>(sc + P.o_nlive);
  int4* live = reinterpret_cast<int4*>(sc + P.o_live);
  float* acc = reinterpret_cast<float*>(sc + P.o_acc);
  float* rec = reinterpret_cast<float*>(sc + P.o_rec);
  float* zs = reinterpret_cast<float*>(sc + P.o_zs);
  float* part = reinterpret_cast<float*>(sc + P.o_part);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (d.J > 0) {
    live_count_kernel<<<P.list_blocks, LIST_THREADS, 0, st>>>(node_mask, S,
                                                              d.J, counts);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    live_list_kernel<<<P.list_blocks, LIST_THREADS, 33 * sizeof(int), st>>>(
        node_mask, edgeless, S, K, d.J, counts, live, n_live);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    static size_t opted_in = 48 * 1024;
    if (P.smem > opted_in) {
      e = cudaFuncSetAttribute(decima_node_encoder_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)P.smem);
      if (e != cudaSuccess) return (int)e;
      opted_in = P.smem;
    }
    decima_node_encoder_bwd_kernel<<<P.blocks, d.wpb * 32, P.smem, st>>>(
        x, adj, level, weights, grad_out, live, n_live, acc, rec, zs, d);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  } else {
    if ((e = cudaMemsetAsync(n_live, 0, sizeof(int), st)) != cudaSuccess)
      return (int)e;
  }
  const long n1 = (long)d.G * d.wtot;
  reduce_warps_kernel<<<(int)((n1 + 255) / 256), 256, 0, st>>>(
      acc, n_live, d.W, d.wtot, d.G, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_groups_kernel<<<(d.ptot + 255) / 256, 256, 0, st>>>(part, d, grad);
  return (int)cudaGetLastError();
}

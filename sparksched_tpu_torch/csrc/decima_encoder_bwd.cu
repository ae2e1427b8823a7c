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
// msg(h0[c]) otherwise — whatever the levels are, topological or not. The
// backward therefore keeps, per job, the two versions of every node and the
// pre-activations of each MLP application, and sweeps the levels in the
// reverse order (0 .. nl-1): at step lvl the fin-version message gradient
// of the nodes updated there is complete (its readers sit at lower levels),
// so it is pushed back into their h_fin; then the update MLP's backward
// gives the gradient of their aggregation, which is scattered along their
// edges into the children's message gradients of the version they read.
// After the sweep the h0-version messages, the leaves' update and prep are
// pushed back. Every MLP application computes every row a dense JAX program
// computes (prep, update(h_init) and msg(h0) over all S rows; the level
// steps over their own rows), so non-finite values spread as in jax.grad.
//
// What bounds it: a job is a chain of ~40 dependent small layers (forward
// and backward), each at most S rows x 32 x 32, on one block; the bytes
// (x, adj, levels, mask, the output gradient, the partial sums) and FLOPs
// of a call are far below a millisecond of the card. The chain's latency
// and the block's barriers set the time; PERF.md has it beside its bound.
//
// What the design does about it, for now: nothing beyond a simple, correct
// kernel. The grid strides over (item, job) pairs; a job with no valid node
// contributes zero and is skipped. Each block keeps both weights and its
// gradient accumulators (the packed layout, 3,680 floats at the flagship
// widths) in shared memory, sums over its jobs in a fixed order, and writes
// its partial gradient to `partials[block]`; a second kernel adds the
// partials in block order, one thread per weight: no float atomics, so two
// runs give the same bits. Threads split each layer over (row, output)
// pairs and each weight gradient over (input, output) pairs, looping over
// rows in order.
//
// Limits: S <= 32, MLPs of 1 to 4 layers, layers at most 64 wide.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (sparksched_tpu_torch/kernels/build.py); bound
// with ctypes through the plain C entry point at the bottom.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 4
#define MAX_WIDTH 64
#define THREADS 128
#define SMEM_MAX (227 * 1024)

struct Mlp {
  int n;                  // dense layers
  int in[MAX_LAYERS];
  int out[MAX_LAYERS];
  int off[MAX_LAYERS];    // float offset of W_T (in x out, row-major); b follows
  int hoff[MAX_LAYERS];   // offset of layer l's pre-activations in a saved row
};

struct Dims {
  Mlp prep, msg, upd;
  int S, F, D, nl, K;
  long jobs;
  int wtotal;             // packed floats (a multiple of 4)
  int hs;                 // saved pre-activation floats per row
  int wd;                 // widest layer output (delta buffers)
  float slope;
};

extern __shared__ __align__(16) float sm[];

__device__ __forceinline__ float act(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

__device__ __forceinline__ float dact(float pre, float slope) {
  return pre >= 0.f ? 1.f : slope;
}

// y = MLP(in) on the rows in `rows`. Hidden pre-activations go to
// save[r * hs + hoff[l] + o]; the output to out[r * os + o] (plus
// add[r * os + o] when given). Rows outside `rows` are not touched.
__device__ void mlp_fwd(const float* W, const Mlp& m, const float* in,
                        int is, unsigned rows, int S, float* save, int hs,
                        float* out, int os, const float* add, float slope) {
  const int t = threadIdx.x;
  for (int l = 0; l < m.n; ++l) {
    const int ni = m.in[l], no = m.out[l];
    const float* Wt = W + m.off[l];
    const float* b = Wt + ni * no;
    const bool last = l == m.n - 1;
    for (int i = t; i < S * no; i += THREADS) {
      const int r = i / no, o = i - r * no;
      if (!((rows >> r) & 1u)) continue;
      float acc = b[o];
      if (l == 0) {
        const float* a = in + r * is;
        for (int k = 0; k < ni; ++k) acc = fmaf(a[k], Wt[k * no + o], acc);
      } else {
        const float* a = save + r * hs + m.hoff[l - 1];
        for (int k = 0; k < ni; ++k)
          acc = fmaf(act(a[k], slope), Wt[k * no + o], acc);
      }
      if (last)
        out[r * os + o] = add ? add[r * os + o] + acc : acc;
      else
        save[r * hs + m.hoff[l] + o] = acc;
    }
    __syncthreads();
  }
}

// Backward of one MLP application (the rows in `rows`, input `in`, saved
// pre-activations `save`) given the output gradient g[r * gs + o]:
// accumulates the weight and bias gradients into GW (the packed layout)
// and, when `gin` is given, adds the input gradient into gin[r * gis + k].
// d0 and d1 are [S, wd] delta buffers.
__device__ void mlp_bwd(const float* W, float* GW, const Mlp& m,
                        const float* in, int is, unsigned rows, int S,
                        const float* save, int hs, const float* g, int gs,
                        float* gin, int gis, float* d0, float* d1, int wd,
                        float slope) {
  const int t = threadIdx.x;
  const float* delta = g;
  int ds = gs;
  for (int l = m.n - 1; l >= 0; --l) {
    const int ni = m.in[l], no = m.out[l];
    const float* Wt = W + m.off[l];
    float* GWt = GW + m.off[l];
    float* Gb = GWt + ni * no;
    // dW_T[k][o] += sum_r a[r][k] * delta[r][o]; db[o] += sum_r delta[r][o]
    for (int i = t; i < ni * no + no; i += THREADS) {
      if (i < ni * no) {
        const int k = i / no, o = i - k * no;
        float acc = 0.f;
        for (int r = 0; r < S; ++r) {
          if (!((rows >> r) & 1u)) continue;
          const float a = l == 0 ? in[r * is + k]
                                 : act(save[r * hs + m.hoff[l - 1] + k], slope);
          acc = fmaf(a, delta[r * ds + o], acc);
        }
        GWt[i] += acc;
      } else {
        const int o = i - ni * no;
        float acc = 0.f;
        for (int r = 0; r < S; ++r)
          if ((rows >> r) & 1u) acc += delta[r * ds + o];
        Gb[o] += acc;
      }
    }
    // the gradient of this layer's input: into the next delta, or gin
    float* nd = (delta == d0) ? d1 : d0;
    if (l > 0 || gin) {
      for (int i = t; i < S * ni; i += THREADS) {
        const int r = i / ni, k = i - r * ni;
        if (!((rows >> r) & 1u)) continue;
        float acc = 0.f;
        const float* dr = delta + r * ds;
        const float* wr = Wt + k * no;
        for (int o = 0; o < no; ++o) acc = fmaf(dr[o], wr[o], acc);
        if (l > 0)
          nd[r * wd + k] = acc * dact(save[r * hs + m.hoff[l - 1] + k], slope);
        else
          gin[r * gis + k] += acc;
      }
    }
    __syncthreads();
    delta = nd;
    ds = wd;
  }
}

__global__ void decima_node_encoder_bwd_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ adj,
    const int32_t* __restrict__ level, const uint8_t* __restrict__ node_mask,
    const uint8_t* __restrict__ edgeless, const float* __restrict__ weights,
    const float* __restrict__ grad_out, float* __restrict__ partials,
    Dims d) {
  const int t = threadIdx.x;
  const int S = d.S, F = d.F, D = d.D, SD = S * D;
  int* ism = reinterpret_cast<int*>(sm);
  // shared memory, float offsets
  float* W = sm;
  float* GW = W + d.wtotal;
  float* xs = GW + d.wtotal;       // [S, F]
  float* hin = xs + S * F;         // [S, D] h_init
  float* h0 = hin + SD;            // [S, D]
  float* hf = h0 + SD;             // [S, D] h_fin
  float* agg = hf + SD;            // [S, D]
  float* m0 = agg + SD;            // [S, D] msg(h0)
  float* mf = m0 + SD;             // [S, D] msg(h_fin)
  float* g_hin = mf + SD;          // [S, D] gradients ...
  float* g_h0 = g_hin + SD;
  float* g_hf = g_h0 + SD;
  float* g_m0 = g_hf + SD;
  float* g_mf = g_m0 + SD;
  float* g_agg = g_mf + SD;
  float* a_prep = g_agg + SD;      // [S, hs] saved pre-activations ...
  float* a_u0 = a_prep + S * d.hs;
  float* a_m0 = a_u0 + S * d.hs;
  float* a_uf = a_m0 + S * d.hs;
  float* a_mf = a_uf + S * d.hs;
  float* d0 = a_mf + S * d.hs;     // [S, wd] deltas
  float* d1 = d0 + S * d.wd;
  int* rowm = reinterpret_cast<int*>(d1 + S * d.wd);  // [32] children
  int* lvls = rowm + 32;                              // [32] levels
  int* vm = lvls + 32;                                // [1] node_mask bits

  for (int i = t; i < d.wtotal; i += THREADS) {
    W[i] = weights[i];
    GW[i] = 0.f;
  }
  const unsigned all = S == 32 ? 0xffffffffu : ((1u << S) - 1u);
  for (long job = blockIdx.x; job < d.jobs; job += gridDim.x) {
    __syncthreads();
    if (t < 32) {
      unsigned row = 0;
      int lv = 0;
      bool v = false;
      if (t < S) {
        const uint8_t* ar = adj + (job * S + t) * S;
        for (int c = 0; c < S; ++c) row |= (ar[c] ? 1u : 0u) << c;
        lv = level[job * S + t];
        v = node_mask[job * S + t] != 0;
      }
      const unsigned vb = __ballot_sync(0xffffffffu, v);
      rowm[t] = (int)row;
      lvls[t] = lv;
      if (t == 0) vm[0] = (int)vb;
    }
    __syncthreads();
    const unsigned V = (unsigned)vm[0];
    if (V == 0) continue;  // every output row is 0: no gradient
    const bool el = edgeless[job / d.K] != 0;
    unsigned HC = 0, U = 0;
    for (int p = 0; p < S; ++p) {
      if (rowm[p]) {
        HC |= 1u << p;
        if (lvls[p] >= 0 && lvls[p] < d.nl) U |= 1u << p;
      }
    }
    const float* gj = grad_out + job * SD;
    for (int i = t; i < S * F; i += THREADS) xs[i] = x[job * S * F + i];
    for (int i = t; i < SD; i += THREADS) {
      g_hin[i] = 0.f;
      g_m0[i] = 0.f;
      g_mf[i] = 0.f;
    }
    __syncthreads();
    mlp_fwd(W, d.prep, xs, F, all, S, a_prep, d.hs, hin, D, nullptr, d.slope);
    if (el) {  // out = where(V, h_init, 0): prep alone carries the gradient
      for (int i = t; i < SD; i += THREADS)
        g_hin[i] = ((V >> (i / D)) & 1u) ? gj[i] : 0.f;
      __syncthreads();
      mlp_bwd(W, GW, d.prep, xs, F, all, S, a_prep, d.hs, g_hin, D, nullptr,
              0, d0, d1, d.wd, d.slope);
      continue;
    }
    // ---- forward: h0, msg(h0), then the level steps deepest first ----
    mlp_fwd(W, d.upd, hin, D, all, S, a_u0, d.hs, h0, D, nullptr, d.slope);
    for (int i = t; i < SD; i += THREADS)
      if ((HC >> (i / D)) & 1u) h0[i] = 0.f;
    __syncthreads();
    mlp_fwd(W, d.msg, h0, D, all, S, a_m0, d.hs, m0, D, nullptr, d.slope);
    for (int lvl = d.nl - 1; lvl >= 0; --lvl) {
      unsigned P = 0;
      for (int p = 0; p < S; ++p)
        if (((U >> p) & 1u) && lvls[p] == lvl) P |= 1u << p;
      if (!P) continue;
      for (int i = t; i < SD; i += THREADS) {  // agg = adj @ msg(h_in)
        const int p = i / D, dd = i - p * D;
        if (!((P >> p) & 1u)) continue;
        unsigned bits = (unsigned)rowm[p];
        float acc = 0.f;
        while (bits) {
          const int c = __ffs(bits) - 1;
          bits &= bits - 1;
          const bool fin = ((U >> c) & 1u) && lvls[c] > lvl;
          acc += fin ? mf[c * D + dd] : m0[c * D + dd];
        }
        agg[i] = acc;
      }
      __syncthreads();
      mlp_fwd(W, d.upd, agg, D, P, S, a_uf, d.hs, hf, D, hin, d.slope);
      mlp_fwd(W, d.msg, hf, D, P, S, a_mf, d.hs, mf, D, nullptr, d.slope);
    }
    // ---- backward: the output, then the levels in reverse order ----
    for (int i = t; i < SD; i += THREADS) {
      const int p = i / D;
      const float g = ((V >> p) & 1u) ? gj[i] : 0.f;
      const bool u = (U >> p) & 1u;
      g_hf[i] = u ? g : 0.f;
      g_h0[i] = u ? 0.f : g;
    }
    __syncthreads();
    for (int lvl = 0; lvl < d.nl; ++lvl) {
      unsigned P = 0;
      for (int p = 0; p < S; ++p)
        if (((U >> p) & 1u) && lvls[p] == lvl) P |= 1u << p;
      if (!P) continue;
      // msg(h_fin) of P: every reader sits at a lower level, done already
      mlp_bwd(W, GW, d.msg, hf, D, P, S, a_mf, d.hs, g_mf, D, g_hf, D, d0,
              d1, d.wd, d.slope);
      for (int i = t; i < SD; i += THREADS) {
        if (!((P >> (i / D)) & 1u)) continue;
        g_agg[i] = 0.f;
        g_hin[i] += g_hf[i];  // h_fin = h_init + update(agg)
      }
      __syncthreads();
      mlp_bwd(W, GW, d.upd, agg, D, P, S, a_uf, d.hs, g_hf, D, g_agg, D, d0,
              d1, d.wd, d.slope);
      // scatter g_agg along the edges into the version each child sent
      for (int i = t; i < SD; i += THREADS) {
        const int c = i / D, dd = i - c * D;
        float acc = 0.f;
        bool any = false;
        for (int p = 0; p < S; ++p)
          if (((P >> p) & 1u) && ((rowm[p] >> c) & 1)) {
            acc += g_agg[p * D + dd];
            any = true;
          }
        if (!any) continue;
        const bool fin = ((U >> c) & 1u) && lvls[c] > lvl;
        (fin ? g_mf : g_m0)[i] += acc;
      }
      __syncthreads();
    }
    // msg(h0) over every row, then h0 = where(has_child, 0, update(h_init))
    mlp_bwd(W, GW, d.msg, h0, D, all, S, a_m0, d.hs, g_m0, D, g_h0, D, d0, d1,
            d.wd, d.slope);
    for (int i = t; i < SD; i += THREADS)
      if ((HC >> (i / D)) & 1u) g_h0[i] = 0.f;
    __syncthreads();
    mlp_bwd(W, GW, d.upd, hin, D, all, S, a_u0, d.hs, g_h0, D, g_hin, D, d0,
            d1, d.wd, d.slope);
    mlp_bwd(W, GW, d.prep, xs, F, all, S, a_prep, d.hs, g_hin, D, nullptr, 0,
            d0, d1, d.wd, d.slope);
  }
  __syncthreads();
  float* part = partials + (long)blockIdx.x * d.wtotal;
  for (int i = t; i < d.wtotal; i += THREADS) part[i] = GW[i];
}

// grad[i] = sum over blocks, in block order, of partials[block][i]
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int blocks, int n,
                                       float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partials[(long)b * n + i];
  grad[i] = acc;
}

static int fill_mlp(Mlp* m, const int* spec, int* off, int* hs, int* wd) {
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
    m->off[l] = *off;
    *off += m->in[l] * m->out[l] + m->out[l];
    m->hoff[l] = h;
    if (l < m->n - 1) h += m->out[l];
    if (m->out[l] > *wd) *wd = m->out[l];
  }
  if (h > *hs) *hs = h;
  return 1 + 2 * m->n;
}

// C entry point. Inputs as the forward's (`decima_node_encoder_launch`):
// x f32[B,K,S,F], adj u8[B,K,S,S], level i32[B,K,S], node_mask u8[B,K,S],
// edgeless u8[B], the packed weights, `mlp_spec`; grad_out f32[B,K,S,D].
// `partials` holds blocks x (the packed length rounded up to 4) floats;
// `grad` receives the gradient in the packed layout. Launches `blocks`
// blocks of the backward (at most B*K) and then the reduction. Returns
// cudaGetLastError() of the launches (0 on success), or -1 for dims the
// kernel does not take.
extern "C" int decima_node_encoder_bwd_launch(
    const float* x, const uint8_t* adj, const int32_t* level,
    const uint8_t* node_mask, const uint8_t* edgeless, const float* weights,
    const float* grad_out, float* partials, float* grad, int B, int K, int S,
    int F, int D, int nl, float slope, const int* mlp_spec, int blocks,
    void* stream) {
  Dims d;
  int off = 0, hs = 0, wd = 0;
  const int* p = mlp_spec;
  int used = fill_mlp(&d.prep, p, &off, &hs, &wd);
  if (used < 0) return -1;
  p += used;
  used = fill_mlp(&d.msg, p, &off, &hs, &wd);
  if (used < 0) return -1;
  p += used;
  used = fill_mlp(&d.upd, p, &off, &hs, &wd);
  if (used < 0) return -1;
  if (S < 1 || S > 32 || F < 1 || D < 1 || B < 0 || K < 0 || blocks < 0)
    return -1;
  if (d.prep.in[0] != F || d.prep.out[d.prep.n - 1] != D ||
      d.msg.in[0] != D || d.msg.out[d.msg.n - 1] != D ||
      d.upd.in[0] != D || d.upd.out[d.upd.n - 1] != D)
    return -1;
  d.S = S; d.F = F; d.D = D; d.nl = nl; d.K = K; d.slope = slope;
  d.jobs = (long)B * K;
  d.wtotal = (off + 3) / 4 * 4;
  d.hs = hs > 0 ? hs : 1;
  d.wd = wd;
  const size_t floats = 2 * (size_t)d.wtotal + (size_t)S * F +
                        13 * (size_t)S * D + 5 * (size_t)S * d.hs +
                        2 * (size_t)S * d.wd + 3 * 32;
  const size_t smem = sizeof(float) * floats;
  if (smem > SMEM_MAX) return -1;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        decima_node_encoder_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks > 0) {
    decima_node_encoder_bwd_kernel<<<blocks, THREADS, smem, st>>>(
        x, adj, level, node_mask, edgeless, weights, grad_out, partials, d);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  reduce_partials_kernel<<<(d.wtotal + 255) / 256, 256, 0, st>>>(
      partials, blocks, d.wtotal, grad);
  return (int)cudaGetLastError();
}

// Decima NodeEncoder: the GNN's level-wise message pass, one block per
// (lane, job).
//
// Replaces: sparksched_tpu/schedulers/decima.py `DecimaNet.__call__`, the
// NodeEncoder part (h_init = mlp_prep(x); h0 = where(has_child, 0,
// mlp_update(h_init)); then a lax.scan over topological levels, deepest
// first, of agg = adj @ mlp_msg(h) and h = h_init + mlp_update(agg) where
// node_level == lvl & has_child; then the per-item edgeless fallback and
// zeroing outside node_mask). The JAX package has no Pallas kernel for it:
// XLA fuses the whole scan into one TPU program.
//
// What bounds it: per call the bytes of x (B*K*S*5 f32), adj (B*K*S*S
// bytes), node_level and node_mask, the output h (B*K*S*16 f32) and the
// ~3.7k weight floats — about 0.6 MB at B=8, K=32, S=20 and 3.5 MB at
// the full-width K=200, a microsecond of HBM time or less; the FLOPs
// the data needs are about a MFLOP. Neither is what limits
// this kernel: each block runs a serial chain of up to 20 levels x
// (msg MLP, aggregation, update MLP), every dense layer closed by a
// block barrier, and the chain's latency sets the time (PERF.md has
// the kernel's time beside its bound). In eager PyTorch the same work
// is ~20 x (3 matmuls + activations + einsum + where) launches per
// decision row.
//
// What the design does about it: ONE launch per call. Each block stages
// the three MLPs' weights and its job's x, adjacency, levels and running
// embeddings in shared memory and runs every level inside the block, so
// nothing between levels touches device memory; levels with no node to
// update are skipped block-uniformly (they are exact no-ops). Layers are
// evaluated with one thread per (node, output) pair in plain FP32 FMAs.
// Shortening the per-block chain (fewer barriers, warp-level layers),
// wgmma, TMA and tuning are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see sparksched_tpu_torch/kernels/build.py);
// bound with ctypes through the plain C entry point at the bottom.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 4
#define THREADS 128

struct MlpDims {
  int n;                    // number of dense layers
  int in[MAX_LAYERS];
  int out[MAX_LAYERS];
  int off[MAX_LAYERS];      // float offset of W (out x in, row-major); b follows
};

struct EncDims {
  MlpDims prep, msg, upd;
  int S, F, D, nl, wtotal, hmax, K;
  float slope;
};

// One MLP over `rows` rows held in shared memory. `in` has row stride
// in_stride, `out` row stride out_stride; hidden layers ping-pong through
// buf0/buf1 (row stride hmax). Every thread of the block must call it.
__device__ void mlp_rows(const float* __restrict__ w, const MlpDims& m,
                         const float* in, int in_stride, float* out,
                         int out_stride, float* buf0, float* buf1, int hmax,
                         int rows, float slope) {
  const float* src = in;
  int src_stride = in_stride;
  for (int l = 0; l < m.n; ++l) {
    const bool last = (l == m.n - 1);
    float* dst = last ? out : ((l & 1) ? buf1 : buf0);
    const int dst_stride = last ? out_stride : hmax;
    const int ni = m.in[l], no = m.out[l];
    const float* W = w + m.off[l];
    const float* bias = W + ni * no;
    for (int t = threadIdx.x; t < rows * no; t += blockDim.x) {
      const int r = t / no, o = t - r * no;
      const float* x = src + r * src_stride;
      const float* wr = W + o * ni;
      float acc = bias[o];
      for (int i = 0; i < ni; ++i) acc = fmaf(x[i], wr[i], acc);
      if (!last) acc = acc >= 0.f ? acc : slope * acc;
      dst[r * dst_stride + o] = acc;
    }
    __syncthreads();
    src = dst;
    src_stride = dst_stride;
  }
}

__global__ void __launch_bounds__(THREADS)
decima_node_encoder_kernel(const float* __restrict__ x,
                           const uint8_t* __restrict__ adj,
                           const int32_t* __restrict__ level,
                           const uint8_t* __restrict__ node_mask,
                           const uint8_t* __restrict__ edgeless,
                           const float* __restrict__ weights,
                           float* __restrict__ out, EncDims d) {
  extern __shared__ float sm[];
  const int S = d.S, F = d.F, D = d.D;
  const long item = blockIdx.x;           // lane * K + job
  const int lane = (int)(item / d.K);

  float* ws = sm;
  float* xs = ws + d.wtotal;              // [S,F]
  float* hinit = xs + S * F;              // [S,D]
  float* h = hinit + S * D;               // [S,D]
  float* tmp = h + S * D;                 // [S,D]
  float* agg = tmp + S * D;               // [S,D]
  float* buf0 = agg + S * D;              // [S,hmax]
  float* buf1 = buf0 + S * d.hmax;        // [S,hmax]
  float* adjs = buf1 + S * d.hmax;        // [S,S] as 0/1 floats
  int* lv = reinterpret_cast<int*>(adjs + S * S);  // [S]
  int* has_child = lv + S;                // [S]

  for (int i = threadIdx.x; i < d.wtotal; i += blockDim.x) ws[i] = weights[i];
  for (int i = threadIdx.x; i < S * F; i += blockDim.x)
    xs[i] = x[item * S * F + i];
  for (int i = threadIdx.x; i < S * S; i += blockDim.x)
    adjs[i] = adj[item * S * S + i] ? 1.f : 0.f;
  for (int p = threadIdx.x; p < S; p += blockDim.x) {
    lv[p] = level[item * S + p];
    int any = 0;
    for (int c = 0; c < S; ++c) any |= adj[item * S * S + p * S + c];
    has_child[p] = any;
  }
  __syncthreads();

  // h_init = prep(x); h0 = where(has_child, 0, update(h_init))
  mlp_rows(ws, d.prep, xs, F, hinit, D, buf0, buf1, d.hmax, S, d.slope);
  mlp_rows(ws, d.upd, hinit, D, tmp, D, buf0, buf1, d.hmax, S, d.slope);
  for (int i = threadIdx.x; i < S * D; i += blockDim.x)
    h[i] = has_child[i / D] ? 0.f : tmp[i];
  __syncthreads();

  for (int l = d.nl - 1; l >= 0; --l) {
    int mine = 0;
    for (int p = threadIdx.x; p < S; p += blockDim.x)
      mine |= (lv[p] == l) & has_child[p];
    if (!__syncthreads_or(mine)) continue;  // no node updates: exact no-op
    mlp_rows(ws, d.msg, h, D, tmp, D, buf0, buf1, d.hmax, S, d.slope);
    for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
      const int p = i / D, dd = i - p * D;
      float acc = 0.f;
      for (int c = 0; c < S; ++c) acc = fmaf(adjs[p * S + c], tmp[c * D + dd], acc);
      agg[i] = acc;
    }
    __syncthreads();
    mlp_rows(ws, d.upd, agg, D, tmp, D, buf0, buf1, d.hmax, S, d.slope);
    for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
      const int p = i / D;
      if (lv[p] == l && has_child[p]) h[i] = hinit[i] + tmp[i];
    }
    __syncthreads();
  }

  const bool el = edgeless[lane] != 0;
  for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
    const int p = i / D;
    const float v = el ? hinit[i] : h[i];
    out[item * S * D + i] = node_mask[item * S + p] ? v : 0.f;
  }
}

static int fill_mlp(MlpDims* m, const int* spec, int* off) {
  // spec: n, in[0..n-1], out[0..n-1]
  m->n = spec[0];
  if (m->n < 1 || m->n > MAX_LAYERS) return -1;
  for (int l = 0; l < m->n; ++l) {
    m->in[l] = spec[1 + l];
    m->out[l] = spec[1 + m->n + l];
    m->off[l] = *off;
    *off += m->in[l] * m->out[l] + m->out[l];
  }
  return 1 + 2 * m->n;
}

static int widest(const MlpDims& m) {
  int w = 0;
  for (int l = 0; l < m.n; ++l) w = m.out[l] > w ? m.out[l] : w;
  return w;
}

// C entry point. `mlp_spec` holds prep, msg, update back to back, each as
// (n, in[0..n-1], out[0..n-1]); `weights` packs each layer's W (out x in,
// row-major) then b, in that order. Returns cudaGetLastError() of the
// launch (0 on success), or -1 for dims the kernel does not take.
extern "C" int decima_node_encoder_launch(
    const float* x, const uint8_t* adj, const int32_t* level,
    const uint8_t* node_mask, const uint8_t* edgeless, const float* weights,
    float* out, int B, int K, int S, int F, int D, int nl, float slope,
    const int* mlp_spec, void* stream) {
  EncDims d;
  int off = 0;
  const int* p = mlp_spec;
  int used = fill_mlp(&d.prep, p, &off);
  if (used < 0) return -1;
  p += used;
  used = fill_mlp(&d.msg, p, &off);
  if (used < 0) return -1;
  p += used;
  used = fill_mlp(&d.upd, p, &off);
  if (used < 0) return -1;
  d.S = S; d.F = F; d.D = D; d.nl = nl; d.K = K; d.slope = slope;
  d.wtotal = off;
  int hmax = widest(d.prep);
  hmax = widest(d.msg) > hmax ? widest(d.msg) : hmax;
  hmax = widest(d.upd) > hmax ? widest(d.upd) : hmax;
  d.hmax = hmax;
  const size_t smem = sizeof(float) * ((size_t)off + S * F + 4 * S * D +
                                       2 * S * hmax + S * S) +
                      sizeof(int) * 2 * S;
  if (smem > 227 * 1024) return -1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decima_node_encoder_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if ((long)B * K == 0) return 0;
  decima_node_encoder_kernel<<<(unsigned)(B * K), THREADS, smem,
                               (cudaStream_t)stream>>>(
      x, adj, level, node_mask, edgeless, weights, out, d);
  return (int)cudaGetLastError();
}

// Decima NodeEncoder: the GNN's level-wise message pass, one (lane, job)
// per block of four warps.
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
// the full-width K=200, a microsecond of HBM time or less; the FLOPs the
// data needs are about a MFLOP. Neither limits this kernel: each job is a
// chain of dependent dense layers — prep, the leaves' update and the
// message MLP up front, then per level with work an aggregation and two
// MLPs on that level's few nodes — and on the serve path a few live jobs
// each have an SM to themselves, so the chain's latency sets the time:
// ~1,100 SM cycles a layer, whatever its rows, for the set-up, index
// arithmetic, FMAs, reduction, store and barrier on one warp's critical
// path (PERF.md has the kernel's time beside its bound).
//
// What the design does about it:
// - One launch per call. A job's four warps (one per SM sub-partition)
//   split each layer: rows over row slots and, when rows are few, a row's
//   inputs over up to a warp's lane groups, summed with shuffles. One
//   warp per job was measured first: a lone warp issues a dependent
//   instruction every ~5 cycles, and its chain ran ~45k cycles per job.
// - One block per job, grid = B*K. The weights are staged into shared
//   memory with cp.async (16 B per thread) while the block loads its
//   job's inputs. Blocks of 2 or 4 jobs sharing one copy of the weights
//   measured 3-5% slower, and a persistent grid of one block per SM no
//   faster (PERF.md).
// - At most 96 registers a thread (`__maxnreg__`). Bounded only by its
//   128 threads, ptxas aims at occupancy and gives the kernel 56
//   registers and 40 B of spills (0.0227 / 0.0250 ms at the serve shapes
//   [8,32] / [8,200] on an H100); left free it takes 161 (0.0196 /
//   0.0232 ms); at 96 it does not spill and measured fastest of the caps
//   from 72 to 161 (0.0193 / 0.0213 ms; PERF.md).
// - Weights are packed transposed, W_T[in][out]: lane o of a layer reads
//   word o, so weight loads are conflict-free. Inputs are read as float4
//   broadcasts, a quarter-warp to a row; each pass runs four independent
//   FMA chains. The MLP table lives in shared memory and every MLP runs
//   through one inlined call site: a called routine kept the table and
//   its saved registers in local memory, ~650 cycles per layer.
// - Only the rows the result needs. h[c] changes only at c's own level,
//   so m[c] = msg(h[c]) is cached: computed from h0 for a node some parent
//   reads before the node's update, refreshed after its update for a node
//   some parent reads later. A level runs the aggregation and update MLP
//   on its own nodes only, found by warp ballots. Nodes outside node_mask
//   that no parent reads are skipped. This is exact whatever the levels
//   are: nodes at a level >= num_levels (or the padding level S, or below
//   0) keep h0 and send msg(h0), as in the JAX scan.
// - Exact early exits: a job whose node_mask row is all false writes
//   zeros; on an edgeless lane the output is h_init masked (prep only).
// - No tensor cores: a layer here is at most 20 rows x 32 x 32, far under
//   wgmma's 64-row tile, and TF32 would leave the 1e-5 tolerance against
//   the plain version (3xTF32 on mma.sync could be revisited if the chain
//   ever became bound by operations). Plain FP32 FMAs on the CUDA cores.
//
// Limits: S <= 32 (a job's nodes are a warp's lanes and adjacency rows
// are 32-bit masks), B*K < 2^31 blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see sparksched_tpu_torch/kernels/build.py);
// bound with ctypes through the plain C entry point at the bottom.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 4
#define JOB_THREADS 128  // four warps per job, one job per block
#define SMEM_MAX (227 * 1024)
#define FULL 0xffffffffu
#define X_CHUNKS 2    // x floats a thread loads ahead: 2 x 128 >= S * F for F <= 8
#define ADJ_CHUNKS 3  // adjacency words a thread loads: 3 x 128 x 4 > 32 x 32 + 6
#define DIMS 64       // ints of the layer table: per MLP n, then per layer
                      // (in, out, W offset, log2 G, float4 chunks)

struct MlpDims {
  int n;                    // number of dense layers
  int in[MAX_LAYERS];
  int out[MAX_LAYERS];
  int off[MAX_LAYERS];      // float offset of W_T (in x out, row-major); b follows
};

struct EncDims {
  MlpDims prep, msg, upd;
  int S, F, D, nl, K;
  int wtotal;               // packed weight floats, a multiple of 4
  int xs, ds, hs;           // row strides, multiples of 4: x, [S,D], hidden
  float slope;
};

// The block's shared memory: the layer table, the weights, then the
// job's scratch. Code below addresses it through `sm` (offsets in floats), so
// every access compiles to a shared-memory load or store.
extern __shared__ __align__(16) float sm[];

// One dense layer, y = x @ W + b (LeakyReLU unless last), over n rows, by
// a job's 128 threads (t). Threads form groups of G = 1 << lg lanes, G the
// layer width rounded up to a power of two (at most 32; wider layers loop
// over output chunks); KS = 1 << lks neighbouring groups of a warp split
// one row's inputs (float4 chunk c goes to slice c % KS) and add their
// sums with shuffles; the remaining slots take rows rs, rs + NS, ..., R
// at a time. Row j of the input is in[(in_idx ? in_idx[j] : j) *
// in_stride]; row j of the output goes to the row out_idx[j] (or j), plus
// the same row of `add` when given. A pass reads 4/R float4s of each of
// its rows (broadcasts: a quarter-warp reads one row; strides are
// multiples of 4) and the matching weights (lane o reads W_T[i][o],
// consecutive words: conflict-free), then runs four independent chains of
// four FMAs. Passes and shuffles are uniform across the job's threads.
template <int R>
__device__ __forceinline__ void dense_r(
    const float* W, int ni, int no, int lg, int nch, int lks, int passes,
    const float* in, int in_stride, const int* in_idx, float* out,
    int out_stride, const int* out_idx, const float* add, int n, bool act,
    float slope, int t) {
  constexpr int KU = 4 / R;
  const int G = 1 << lg, KS = 1 << lks;
  const int gi = t >> lg, ol = t & (G - 1), sl = gi & (KS - 1), rs = gi >> lks;
  const int NS = (JOB_THREADS >> lg) >> lks;  // row slots
  const float* bias = W + ni * no;
  for (int o0 = 0; o0 < no; o0 += G) {
    const int o = o0 + ol;
    const bool live = o < no;
    const int oc = live ? o : no - 1;
    for (int p = 0; p < passes; ++p) {
      const int rb = rs + p * R * NS;
      const float* ip[R];
      float acc[R][KU];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = rb + j * NS < n ? rb + j * NS : 0;
        ip[j] = in + (in_idx ? in_idx[r] : r) * in_stride;
#pragma unroll
        for (int u = 0; u < KU; ++u) acc[j][u] = 0.f;
      }
      int c = sl;
      for (; c + (KU - 1) * KS < nch; c += KU * KS) {
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int k = (c + u * KS) * 4;
          const float* wp = W + k * no + oc;
          const float w0 = wp[0], w1 = wp[no], w2 = wp[2 * no], w3 = wp[3 * no];
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(ip[j] + k);
            acc[j][u] = fmaf(v.w, w3, fmaf(v.z, w2, fmaf(v.y, w1,
                        fmaf(v.x, w0, acc[j][u]))));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < KU - 1; ++u) {  // the last chunks, still in parallel
        if (c + u * KS < nch) {
          const int k = (c + u * KS) * 4;
          const float* wp = W + k * no + oc;
          const float w0 = wp[0], w1 = wp[no], w2 = wp[2 * no], w3 = wp[3 * no];
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(ip[j] + k);
            acc[j][u] = fmaf(v.w, w3, fmaf(v.z, w2, fmaf(v.y, w1,
                        fmaf(v.x, w0, acc[j][u]))));
          }
        }
      }
      if (sl == 0)
        for (int i = nch * 4; i < ni; ++i) {
          const float w = W[i * no + oc];
#pragma unroll
          for (int j = 0; j < R; ++j) acc[j][0] = fmaf(ip[j][i], w, acc[j][0]);
        }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float v = acc[j][0];
#pragma unroll
        for (int u = 1; u < KU; ++u) v += acc[j][u];
        for (int off = G; off < G * KS; off <<= 1)
          v += __shfl_xor_sync(FULL, v, off);
        const int r = rb + j * NS;
        if (sl == 0 && live && r < n) {
          v += bias[oc];
          if (act) v = v >= 0.f ? v : slope * v;
          const int ro = (out_idx ? out_idx[r] : r) * out_stride + o;
          out[ro] = add ? add[ro] + v : v;
        }
      }
    }
  }
}

// One MLP (table row mi: 0 prep, 1 msg, 2 update) over n rows by the
// job's threads; operands are float offsets into `sm` (index lists and
// `add` -1 when absent). Hidden layers ping-pong through buf0/buf1
// (compact rows, stride hs); every layer ends at a block barrier. A
// layer splits a row's inputs over KS = 1 << lks lane groups, the most
// that a warp holds, that leave a row slot for every row and that keep
// two float4 chunks per slice; all of it in shifts, since a lone warp
// pays ~5 cycles per dependent instruction.
__device__ __forceinline__ void mlp(int mi, int in, int in_stride, int in_idx,
                                    int out, int out_stride, int out_idx,
                                    int add, int n, int buf0, int buf1, int hs,
                                    float slope, int t) {
  const int* ism = reinterpret_cast<const int*>(sm);
  const int* dm = ism + mi * 21;  // the table sits at the start of sm
  const int layers = dm[0];
  const int ln = n > 1 ? 32 - __clz(n - 1) : 0;  // ceil(log2 n)
  for (int l = 0; l < layers; ++l) {
    const bool last = l == layers - 1;
    const int* e = dm + 1 + 5 * l;
    const int ni = e[0], no = e[1], lg = e[3], nch = e[4];
    int lks = min(5 - lg, 7 - lg - ln);
    lks = max(0, min(lks, nch >= 2 ? 30 - __clz(nch) : 0));
    const int lns = 7 - lg - lks;  // log2 of the row slots
    const int per_slot = (n + (1 << lns) - 1) >> lns;
    const int lr = per_slot >= 3 ? 2 : per_slot == 2 ? 1 : 0;  // log2 R
    const int passes = (n + (1 << (lns + lr)) - 1) >> (lns + lr);
    const int dst = last ? out : ((l & 1) ? buf1 : buf0);
    const int dstride = last ? out_stride : hs;
    const float* W = sm + DIMS + e[2];
    const float* src = sm + in;
    const int* si = in_idx >= 0 ? ism + in_idx : nullptr;
    const int* di = last && out_idx >= 0 ? ism + out_idx : nullptr;
    const float* ad = last && add >= 0 ? sm + add : nullptr;
    if (lr == 2)
      dense_r<4>(W, ni, no, lg, nch, lks, passes, src, in_stride, si, sm + dst,
                 dstride, di, ad, n, !last, slope, t);
    else if (lr == 1)
      dense_r<2>(W, ni, no, lg, nch, lks, passes, src, in_stride, si, sm + dst,
                 dstride, di, ad, n, !last, slope, t);
    else
      dense_r<1>(W, ni, no, lg, nch, lks, passes, src, in_stride, si, sm + dst,
                 dstride, di, ad, n, !last, slope, t);
    __syncthreads();
    in = dst;
    in_stride = hs;
    in_idx = -1;
  }
}

// The lanes set in `mask`, in order, into the int list at sm offset `idx`
// (each warp keeps its own copy); returns their count.
__device__ __forceinline__ int rows_of(unsigned mask, int idx, int lane) {
  if ((mask >> lane) & 1u)
    reinterpret_cast<int*>(sm)[idx + __popc(mask & ((1u << lane) - 1u))] =
        lane;
  __syncwarp();
  return __popc(mask);
}

// out[p] = rows p of `src` where V has p, else 0 (S x D floats)
__device__ __forceinline__ void write_rows(float* o, int src, int ds,
                                           unsigned V, int S, int D, int t) {
  for (int i = t; i < S * D; i += JOB_THREADS) {
    const int p = i / D;
    o[i] = ((V >> p) & 1u) ? sm[src + p * ds + i - p * D] : 0.f;
  }
}

static __device__ __forceinline__ void fill_dims(const MlpDims& m, int* dst) {
  dst[0] = m.n;
#pragma unroll
  for (int l = 0; l < MAX_LAYERS; ++l) {
    int* e = dst + 1 + 5 * l;
    e[0] = m.in[l];
    e[1] = m.out[l];
    e[2] = m.off[l];
    e[3] = m.out[l] > 16 ? 5 : 32 - __clz(m.out[l] - 1);  // log2 of G
    e[4] = m.in[l] >> 2;
  }
}

enum Stage { PREP, H0, MSG0, LEVEL, REFRESH, DONE };

__global__ void __maxnreg__(96)
decima_node_encoder_kernel(const float* __restrict__ x,
                           const uint8_t* __restrict__ adj,
                           const int32_t* __restrict__ level,
                           const uint8_t* __restrict__ node_mask,
                           const uint8_t* __restrict__ edgeless,
                           const float* __restrict__ weights,
                           float* __restrict__ out, EncDims d) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long job = blockIdx.x;
  const int S = d.S, F = d.F, D = d.D, ds = d.ds, hs = d.hs;
  int* ism = reinterpret_cast<int*>(sm);

  // stage the MLP table and the weights (cp.async, 16 B per thread); the
  // copy is waited for once the job's loads are issued
  if (t == 0) {
    fill_dims(d.prep, ism);
    fill_dims(d.msg, ism + 21);
    fill_dims(d.upd, ism + 42);
  }
  {
    const unsigned base = (unsigned)__cvta_generic_to_shared(sm + DIMS);
    for (int i = t; i < d.wtotal / 4; i += JOB_THREADS)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       base + 16u * i),
                   "l"(weights + 4 * i));
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // the job's scratch, float offsets into sm
  const int xs = DIMS + d.wtotal;         // [S, xs]
  const int hinit = xs + S * d.xs;        // [S, ds]
  const int h = hinit + S * ds;           // [S, ds]
  const int m = h + S * ds;               // [S, ds]: msg(h)
  const int agg = m + S * ds;             // [S, ds], compact
  const int buf0 = agg + S * ds;          // [S, hs], compact
  const int buf1 = buf0 + S * hs;         // [S, hs], compact
  const int mk = buf1 + S * hs;           // int [32]: node_mask
  const int lv = mk + 32;                 // int [32]: levels
  const int rowm = lv + 32;               // int [32]: children
  const int idx = rowm + 32 + warp * 32;  // int [32] per warp
  const int adjw = rowm + 32 + 4 * 32;    // u32 [128 * ADJ_CHUNKS]

  // issue every load of the job at once: thread c < S reads node c's mask
  // and level; all threads read coalesced slices of x and of the aligned
  // 32-bit words that cover the adjacency block
  const bool el = edgeless[(int)job / d.K] != 0;
  bool valid = false;
  int myl = -1;
  if (t < S) {
    valid = node_mask[job * S + t] != 0;
    myl = level[job * S + t];
  }
  float xv[X_CHUNKS];
  const float* xj = x + job * S * F;
#pragma unroll
  for (int k = 0; k < X_CHUNKS; ++k) {
    const int i = t + JOB_THREADS * k;
    xv[k] = i < S * F ? xj[i] : 0.f;
  }
  const uint8_t* ab_g = adj + job * S * S;
  const int shift = (int)((uintptr_t)ab_g & 3u);
  const int nw = (shift + S * S + 3) >> 2;
  const unsigned* words = reinterpret_cast<const unsigned*>(ab_g - shift);
  unsigned aw[ADJ_CHUNKS];
#pragma unroll
  for (int k = 0; k < ADJ_CHUNKS; ++k) {
    const int i = t + JOB_THREADS * k;
    aw[k] = i < nw ? words[i] : 0u;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (t < 32) {
    ism[mk + t] = valid;
    ism[lv + t] = myl;
  }
#pragma unroll
  for (int k = 0; k < X_CHUNKS; ++k) {
    const int i = t + JOB_THREADS * k, r = i / F;
    if (i < S * F) sm[xs + r * d.xs + i - r * F] = xv[k];
  }
  for (int i = t + JOB_THREADS * X_CHUNKS; i < S * F; i += JOB_THREADS) {
    const int r = i / F;
    sm[xs + r * d.xs + i - r * F] = xj[i];
  }
#pragma unroll
  for (int k = 0; k < ADJ_CHUNKS; ++k)
    if (t + JOB_THREADS * k < nw) ism[adjw + t + JOB_THREADS * k] = (int)aw[k];
  __syncthreads();

  // every warp derives the same masks from shared memory: lane c is node c
  const bool in_s = lane < S;
  const unsigned V = __ballot_sync(FULL, in_s && ism[mk + lane]);  // node_mask
  float* o = out + job * S * D;
  if (V == 0) {
    for (int i = t; i < S * D; i += JOB_THREADS) o[i] = 0.f;
    return;
  }
  unsigned row = 0, col = 0;  // this node's children and parents
  const int ml = in_s ? ism[lv + lane] : -1;
  if (in_s && !el) {
    const uint8_t* ab = reinterpret_cast<const uint8_t*>(sm + adjw) + shift;
#pragma unroll 4
    for (int c = 0; c < S; ++c) {
      row |= (ab[lane * S + c] ? 1u : 0u) << c;
      col |= (ab[c * S + lane] ? 1u : 0u) << c;
    }
  }
  ism[rowm + lane] = (int)row;  // every warp writes the same masks
  const bool upd = row != 0 && ml >= 0 && ml < d.nl;
  const unsigned U = __ballot_sync(FULL, upd);  // nodes updated at a level
  const unsigned leaf = __ballot_sync(FULL, in_s && row == 0);
  // Who reads m[lane]: each parent updated at a level; a parent at a
  // level >= ours reads it before our update (or we are never updated),
  // one at a lower level after it.
  unsigned par = col & U;
  bool before = false, after = false;
  while (par) {
    const int q = __ffs(par) - 1;
    par &= par - 1;
    if (!upd || ism[lv + q] >= ml) before = true;
    else after = true;
  }
  const unsigned NI = __ballot_sync(FULL, before);  // m from h0
  const unsigned NR = __ballot_sync(FULL, after);   // m after update
  const unsigned todo0 = U & (V | NR);              // updates we need
  if (!el)  // h = 0 for nodes with children, until their update
    for (int i = t; i < S * D; i += JOB_THREADS) {
      const int p = i / D;
      if (!((leaf >> p) & 1u)) sm[h + p * ds + i - p * D] = 0.f;
    }

  // the job's MLPs in order, through one call site: prep; the leaves'
  // update (h0); the first messages; then per level with work, deepest
  // first, the aggregation and update of its nodes and their new
  // messages. An edgeless lane runs prep only and keeps h_init.
  unsigned todo = U, Pn = 0;
  int stage = PREP;
  while (stage != DONE) {
    int mi, in, ins, out_r, in_l = idx, add = -1, next, n;
    if (stage == PREP) {
      mi = 0; in = xs; ins = d.xs; out_r = hinit;
      n = rows_of(el ? V : V | todo0 | (NI & leaf), idx, lane);
      next = el ? DONE : H0;
    } else if (stage == H0) {
      mi = 2; in = hinit; ins = ds; out_r = h;
      n = rows_of(leaf & (V | NI), idx, lane);
      next = NI ? MSG0 : LEVEL;
    } else if (stage == MSG0 || stage == REFRESH) {
      mi = 1; in = h; ins = ds; out_r = m;
      n = rows_of(stage == MSG0 ? NI : Pn & NR, idx, lane);
      next = LEVEL;
    } else {  // LEVEL: the next level with a node to update
      Pn = 0;
      while (todo && !Pn) {
        const int l = __reduce_max_sync(FULL, ((todo >> lane) & 1u) ? ml : -1);
        const unsigned P = __ballot_sync(FULL, ((todo >> lane) & 1u) && ml == l);
        todo &= ~P;
        Pn = P & todo0;
      }
      if (!Pn) break;
      n = rows_of(Pn, idx, lane);
      for (int i = t; i < n * D; i += JOB_THREADS) {  // agg = adj @ m
        const int j = i / D, dd = i - j * D;
        unsigned bits = (unsigned)ism[rowm + ism[idx + j]];
        float acc = 0.f;
        while (bits) {
          const int c = __ffs(bits) - 1;
          bits &= bits - 1;
          acc += sm[m + c * ds + dd];
        }
        sm[agg + j * ds + dd] = acc;
      }
      __syncthreads();
      mi = 2; in = agg; ins = ds; in_l = -1; out_r = h; add = hinit;
      next = (Pn & NR) ? REFRESH : LEVEL;  // h = h_init + update(agg)
    }
    if (n)
      mlp(mi, in, ins, in_l, out_r, ds, idx, add, n, buf0, buf1, hs, d.slope,
          t);
    stage = next;
  }

  write_rows(o, el ? hinit : h, ds, V, S, D, t);
}

static int fill_mlp(MlpDims* m, const int* spec, int* off) {
  // spec: n, in[0..n-1], out[0..n-1]
  m->n = spec[0];
  if (m->n < 1 || m->n > MAX_LAYERS) return -1;
  for (int l = 0; l < m->n; ++l) {
    m->in[l] = spec[1 + l];
    m->out[l] = spec[1 + m->n + l];
    if (m->in[l] < 1 || m->out[l] < 1) return -1;
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
// (n, in[0..n-1], out[0..n-1]); `weights` packs each layer's W_T (in x
// out, row-major) then b, in that order, zero-padded to a multiple of 4
// floats (16-byte aligned). Launches B*K blocks of 128 threads, one job
// each. Returns cudaGetLastError() of the launch (0 on success), or -1
// for dims the kernel does not take.
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
  if (S < 1 || S > 32 || F < 1 || D < 1 || B < 0 || K < 0) return -1;
  const long jobs = (long)B * K;
  if (jobs > 0x7fffffff) return -1;
  d.S = S; d.F = F; d.D = D; d.nl = nl; d.K = K; d.slope = slope;
  d.wtotal = (off + 3) / 4 * 4;
  int hmax = widest(d.prep);
  hmax = widest(d.msg) > hmax ? widest(d.msg) : hmax;
  hmax = widest(d.upd) > hmax ? widest(d.upd) : hmax;
  d.xs = (F + 3) / 4 * 4;
  d.ds = (D + 3) / 4 * 4;
  d.hs = (hmax + 3) / 4 * 4;
  const size_t job_floats = (size_t)S * (d.xs + 4 * d.ds + 2 * d.hs) +
                            3 * 32 + 4 * 32 + JOB_THREADS * ADJ_CHUNKS;
  const size_t smem = sizeof(float) * (DIMS + d.wtotal + job_floats);
  if (smem > SMEM_MAX) return -1;
  static size_t opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        decima_node_encoder_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  if (jobs == 0) return 0;
  decima_node_encoder_kernel<<<(unsigned)jobs, JOB_THREADS, smem,
                               (cudaStream_t)stream>>>(
      x, adj, level, node_mask, edgeless, weights, out, d);
  return (int)cudaGetLastError();
}

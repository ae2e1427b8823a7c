// Decima NodeEncoder in bfloat16: one job's forward and backward, as one
// block of threads computes them. Included by decima_encoder_bf16.cu (the
// forward kernel) and decima_encoder_bwd_bf16.cu (the backward kernel);
// plain C++ under g++, where a "block" is one thread (t = 0, nt = 1) and
// the barriers are no-ops, so the same code runs on the CPU in tests.
//
// The function is the JAX package's NodeEncoder under
// compute_dtype="bfloat16" (sparksched_tpu/schedulers/decima.py:206-223,
// 244-274, 285-288) and the port's plain version in bf16
// (kernels/decima_encoder.py:decima_node_encoder_ref): x, the weights and
// every stored value are bf16; a Dense layer sums its products in f32
// (exact: a product of two bf16 values fits an f32), rounds the sum to bf16,
// adds the bias and rounds again; LeakyReLU multiplies by the slope rounded
// to bf16 and rounds; the aggregation adj @ msg(h) sums the children in f32
// and rounds once; h = h_init + update(agg) rounds. The backward rounds each
// cotangent where autograd of that plain version rounds it (the input
// gradient of a Dense once after its f32 sum, LeakyReLU's slope product,
// adj^T @ g_agg, the sums of a value's uses), and keeps the weight
// gradients in f32: the plain version rounds each use's weight gradient to
// bf16 before it is summed over uses in f32, the kernels do not.
//
// The computation is the plain version's, row for row: prep and update
// over all S rows, then per level with a node to update, deepest first, the
// messages of all rows, the aggregation and update of that level's nodes.
// A level with no node to update changes nothing and is skipped.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define ENC_HD __device__ __forceinline__
#define ENC_HHD __host__ __device__ __forceinline__
#define ENC_SYNC() __syncthreads()
#else
#include <cmath>
#define ENC_HD inline
#define ENC_HHD inline
#define ENC_SYNC() ((void)0)
#endif

#define ENC_MAX_LAYERS 4
#define ENC_MAX_S 32

enum { ENC_PREP = 0, ENC_MSG = 1, ENC_UPD = 2 };

struct EncMlp {
  int n;                      // dense layers
  int in[ENC_MAX_LAYERS];
  int out[ENC_MAX_LAYERS];
  int off[ENC_MAX_LAYERS];    // element offset of W_T (in x out); b follows
};

struct EncDims {
  EncMlp mlp[3];              // prep, msg, update
  int S, F, D, nl, K;
  int wtotal;                 // packed weight elements, a multiple of 8
  int hs;                     // row stride of the layer buffers: the widest layer
  float slope;                // LeakyReLU's slope, rounded to bf16
};

struct Blk {
  int t, nt;  // this thread and the block's threads
};

ENC_HD float bf2f(uint16_t v) {
  const uint32_t u = (uint32_t)v << 16;
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

// round to nearest even, as torch's and XLA's float -> bfloat16 casts
ENC_HD uint16_t f2bf(float f) {
#ifdef __CUDA_ARCH__
  uint32_t u = __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
#endif
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

ENC_HD float rnd(float f) { return bf2f(f2bf(f)); }

ENC_HD float leaky(float z, float slope) {
  return z >= 0.f ? z : rnd(slope * z);
}

// One MLP over the rows set in `sel` (row p of the input at in + p *
// in_stride): layer l's pre-activations, bf16, into Z + l * S * hs (row
// stride hs); the MLP's output is the last layer's. A hidden layer's input
// is LeakyReLU of the previous layer's stored pre-activation.
ENC_HD void mlp_fwd(Blk b, const EncMlp& m, const uint16_t* W,
                    const uint16_t* in, int in_stride, uint32_t sel, int S,
                    uint16_t* Z, int hs, float slope) {
  for (int l = 0; l < m.n; ++l) {
    const int ni = m.in[l], no = m.out[l];
    const uint16_t* Wl = W + m.off[l];
    const uint16_t* bl = Wl + ni * no;
    const uint16_t* src = l == 0 ? in : Z + (l - 1) * S * hs;
    const int ss = l == 0 ? in_stride : hs;
    uint16_t* dst = Z + l * S * hs;
    for (int idx = b.t; idx < S * no; idx += b.nt) {
      const int p = idx / no, o = idx - p * no;
      if (!((sel >> p) & 1u)) continue;
      const uint16_t* ir = src + p * ss;
      float acc = 0.f;
      for (int i = 0; i < ni; ++i) {
        float a = bf2f(ir[i]);
        if (l > 0) a = leaky(a, slope);
        acc = fmaf(a, bf2f(Wl[i * no + o]), acc);
      }
      dst[p * hs + o] = f2bf(rnd(acc) + bf2f(bl[o]));
    }
    ENC_SYNC();
  }
}

// The MLP's backward over the rows in `sel`, its forward's pre-activations
// in Z (mlp_fwd's), the last layer's cotangent in G0 (row stride hs, bf16).
// Adds each weight's and bias's gradient, summed over the rows in f32, to
// acc (the packed layout); writes the input's cotangent to gin (row stride
// gin_stride) when given. G0 and G1 are overwritten.
ENC_HD void mlp_bwd(Blk b, const EncMlp& m, const uint16_t* W,
                    const uint16_t* in, int in_stride, uint32_t sel, int S,
                    const uint16_t* Z, int hs, uint16_t* G0, uint16_t* G1,
                    uint16_t* gin, int gin_stride, float* acc, float slope) {
  uint16_t* g = G0;
  uint16_t* gn = G1;
  for (int l = m.n - 1; l >= 0; --l) {
    const int ni = m.in[l], no = m.out[l];
    const uint16_t* Wl = W + m.off[l];
    float* aw = acc + m.off[l];
    const uint16_t* src = l == 0 ? in : Z + (l - 1) * S * hs;
    const int ss = l == 0 ? in_stride : hs;
    for (int idx = b.t; idx < (ni + 1) * no; idx += b.nt) {
      const int i = idx / no, o = idx - i * no;  // i == ni: the bias
      float s = 0.f;
      for (int p = 0; p < S; ++p) {
        if (!((sel >> p) & 1u)) continue;
        const float gz = bf2f(g[p * hs + o]);
        if (i < ni) {
          float a = bf2f(src[p * ss + i]);
          if (l > 0) a = leaky(a, slope);
          s = fmaf(a, gz, s);
        } else {
          s += gz;
        }
      }
      aw[idx] += s;
    }
    if (l > 0 || gin) {
      for (int idx = b.t; idx < S * ni; idx += b.nt) {
        const int p = idx / ni, i = idx - p * ni;
        if (!((sel >> p) & 1u)) continue;
        float s = 0.f;
        for (int o = 0; o < no; ++o)
          s = fmaf(bf2f(g[p * hs + o]), bf2f(Wl[i * no + o]), s);
        float ga = rnd(s);
        if (l > 0) {
          const float z = bf2f(Z[(l - 1) * S * hs + p * hs + i]);
          if (!(z >= 0.f)) ga = rnd(slope * ga);
          gn[p * hs + i] = f2bf(ga);
        } else {
          gin[p * gin_stride + i] = f2bf(ga);
        }
      }
    }
    ENC_SYNC();
    uint16_t* tmp = g;
    g = gn;
    gn = tmp;
  }
}

// A block's shared memory, carved by enc_carve: the weights, then one
// job's inputs and buffers (bf16 unless noted).
struct EncSm {
  uint16_t* W;      // [wtotal]
  uint16_t* x;      // [S, F]
  uint16_t* hin;    // [S, D] h_init = prep(x)
  uint16_t* h;      // [S, D]
  uint16_t* agg;    // [S, D]
  uint16_t* Za;     // [4, S, hs] pre-activations (msg)
  uint16_t* Zb;     // [4, S, hs] pre-activations (prep, update)
  uint32_t* rows;   // [S] the node's children, a bit each
  int* lvl;         // [S]
  int* misc;        // [4]: node_mask bits, edgeless, executed levels
  // the backward's
  uint16_t* gh;     // [S, D] cotangent of h
  uint16_t* ghin;   // [S, D] cotangent of h_init
  uint16_t* gpass;  // [S, D]
  uint16_t* gtmp;   // [S, D]
  uint16_t* G0;     // [S, hs]
  uint16_t* G1;     // [S, hs]
  uint16_t* hist;   // [S, S, D] h before each executed level
  int* lvlist;      // [S] the executed levels, in order
  float* acc;       // f32 [wtotal] the block's weight gradients
};

ENC_HHD size_t enc_align(size_t n) { return (n + 15) & ~(size_t)15; }

// Carve `base` (16-byte aligned); returns the bytes used. The backward's
// buffers only when `bwd`.
ENC_HHD size_t enc_carve(const EncDims& d, bool bwd, unsigned char* base,
                        EncSm* s) {
  const int S = d.S, D = d.D, hs = d.hs;
  size_t off = 0;
#define ENC_TAKE(field, type, count)                                  \
  do {                                                                \
    if (s) s->field = reinterpret_cast<type*>(base + off);            \
    off = enc_align(off + sizeof(type) * (size_t)(count));            \
  } while (0)
  ENC_TAKE(W, uint16_t, d.wtotal);
  ENC_TAKE(x, uint16_t, S * d.F);
  ENC_TAKE(hin, uint16_t, S * D);
  ENC_TAKE(h, uint16_t, S * D);
  ENC_TAKE(agg, uint16_t, S * D);
  ENC_TAKE(Za, uint16_t, ENC_MAX_LAYERS * S * hs);
  ENC_TAKE(Zb, uint16_t, ENC_MAX_LAYERS * S * hs);
  ENC_TAKE(rows, uint32_t, S);
  ENC_TAKE(lvl, int, S);
  ENC_TAKE(misc, int, 4);
  if (bwd) {
    ENC_TAKE(gh, uint16_t, S * D);
    ENC_TAKE(ghin, uint16_t, S * D);
    ENC_TAKE(gpass, uint16_t, S * D);
    ENC_TAKE(gtmp, uint16_t, S * D);
    ENC_TAKE(G0, uint16_t, S * hs);
    ENC_TAKE(G1, uint16_t, S * hs);
    // sized for S levels whatever nl, so a block's bytes (and the
    // backward's grid) depend on the widths only
    ENC_TAKE(hist, uint16_t, S * S * D);
    ENC_TAKE(lvlist, int, S);
    ENC_TAKE(acc, float, d.wtotal);
  }
#undef ENC_TAKE
  return off;
}

// The block's weights into shared memory (the packed bf16 copy; wtotal is
// even, so 32-bit words).
ENC_HD void enc_load_weights(Blk b, const EncDims& d, const uint16_t* W,
                             EncSm& s) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(W);
  uint32_t* dst = reinterpret_cast<uint32_t*>(s.W);
  for (int i = b.t; i < d.wtotal / 2; i += b.nt) dst[i] = src[i];
}

// Load job `job`'s inputs; returns its node_mask bits (0: a dead job, whose
// output is zero and whose gradient is zero). Ends at a barrier.
ENC_HD uint32_t enc_load_job(Blk b, const EncDims& d, long job,
                             const uint16_t* x, const uint8_t* adj,
                             const int32_t* level, const uint8_t* node_mask,
                             const uint8_t* edgeless, EncSm& s) {
  const int S = d.S, F = d.F;
  ENC_SYNC();  // the previous job's reads of these buffers are done
  if (b.t == 0) {
    uint32_t V = 0;
    for (int p = 0; p < S; ++p)
      if (node_mask[job * S + p]) V |= 1u << p;
    s.misc[0] = (int)V;
    s.misc[1] = edgeless[job / d.K] != 0;
  }
  for (int p = b.t; p < S; p += b.nt) {
    const uint8_t* ar = adj + (job * S + p) * S;
    uint32_t r = 0;
    for (int c = 0; c < S; ++c)
      if (ar[c]) r |= 1u << c;
    s.rows[p] = r;
    s.lvl[p] = level[job * S + p];
  }
  for (int i = b.t; i < S * F; i += b.nt) s.x[i] = x[job * S * F + i];
  ENC_SYNC();
  return (uint32_t)s.misc[0];
}

// the nodes updated at level lvl: at that level, with a child
ENC_HD uint32_t enc_level_nodes(const EncDims& d, const EncSm& s, int lvl) {
  uint32_t P = 0;
  for (int p = 0; p < d.S; ++p)
    if (s.lvl[p] == lvl && s.rows[p]) P |= 1u << p;
  return P;
}

// agg[p] = sum of msg(h)[c] over the children c of each p in P, the sum in
// f32 in child order, rounded once; m the msg MLP's output (stride hs)
ENC_HD void enc_aggregate(Blk b, const EncDims& d, EncSm& s, uint32_t P,
                          const uint16_t* m) {
  const int D = d.D;
  for (int idx = b.t; idx < d.S * D; idx += b.nt) {
    const int p = idx / D, o = idx - p * D;
    if (!((P >> p) & 1u)) continue;
    uint32_t bits = s.rows[p];
    float acc = 0.f;
    for (int c = 0; c < d.S; ++c)
      if ((bits >> c) & 1u) acc += bf2f(m[c * d.hs + o]);
    s.agg[idx] = f2bf(acc);
  }
  ENC_SYNC();
}

// The job's forward, its inputs loaded (enc_load_job) and not edgeless:
// h_init, h0, then each level with work, deepest first. With `record`,
// h before each executed level goes to hist and the level to lvlist;
// returns the number of executed levels.
ENC_HD int enc_forward(Blk b, const EncDims& d, EncSm& s, bool record) {
  const int S = d.S, D = d.D, hs = d.hs;
  const uint32_t all = S == 32 ? 0xffffffffu : (1u << S) - 1u;
  const EncMlp& prep = d.mlp[ENC_PREP];
  const EncMlp& msg = d.mlp[ENC_MSG];
  const EncMlp& upd = d.mlp[ENC_UPD];
  mlp_fwd(b, prep, s.W, s.x, d.F, all, S, s.Zb, hs, d.slope);
  const uint16_t* zp = s.Zb + (prep.n - 1) * S * hs;
  for (int idx = b.t; idx < S * D; idx += b.nt) {
    const int p = idx / D;
    s.hin[idx] = zp[p * hs + idx - p * D];
  }
  ENC_SYNC();
  if (s.misc[1]) return 0;  // an edgeless lane keeps h_init
  mlp_fwd(b, upd, s.W, s.hin, D, all, S, s.Zb, hs, d.slope);
  const uint16_t* zu = s.Zb + (upd.n - 1) * S * hs;
  for (int idx = b.t; idx < S * D; idx += b.nt) {
    const int p = idx / D;
    s.h[idx] = s.rows[p] ? (uint16_t)0 : zu[p * hs + idx - p * D];
  }
  ENC_SYNC();
  int e = 0;
  for (int lvl = d.nl - 1; lvl >= 0; --lvl) {
    const uint32_t P = enc_level_nodes(d, s, lvl);
    if (!P) continue;
    if (record) {
      for (int i = b.t; i < S * D; i += b.nt) s.hist[e * S * D + i] = s.h[i];
      if (b.t == 0) s.lvlist[e] = lvl;
    }
    ++e;
    mlp_fwd(b, msg, s.W, s.h, D, all, S, s.Za, hs, d.slope);
    enc_aggregate(b, d, s, P, s.Za + (msg.n - 1) * S * hs);
    mlp_fwd(b, upd, s.W, s.agg, D, P, S, s.Zb, hs, d.slope);
    for (int idx = b.t; idx < S * D; idx += b.nt) {
      const int p = idx / D;
      if ((P >> p) & 1u)
        s.h[idx] = f2bf(bf2f(s.hin[idx]) + bf2f(zu[p * hs + idx - p * D]));
    }
    ENC_SYNC();
  }
  return e;
}

// One job of the forward: out[p] = node_mask[p] ? h[p] : 0 (h_init on an
// edgeless lane), the weights already in s.W.
ENC_HD void enc_forward_job(Blk b, const EncDims& d, EncSm& s, long job,
                            const uint16_t* x, const uint8_t* adj,
                            const int32_t* level, const uint8_t* node_mask,
                            const uint8_t* edgeless, uint16_t* out) {
  const int S = d.S, D = d.D;
  uint16_t* o = out + job * S * D;
  const uint32_t V =
      enc_load_job(b, d, job, x, adj, level, node_mask, edgeless, s);
  if (V) enc_forward(b, d, s, false);
  const uint16_t* h = s.misc[1] ? s.hin : s.h;
  for (int idx = b.t; idx < S * D; idx += b.nt)
    o[idx] = ((V >> (idx / D)) & 1u) ? h[idx] : (uint16_t)0;
  ENC_SYNC();
}

// One job of the backward: its weight gradients, given dL/dh (grad_h,
// bf16), added to s.acc. A dead job adds nothing.
ENC_HD void enc_backward_job(Blk b, const EncDims& d, EncSm& s, long job,
                             const uint16_t* x, const uint8_t* adj,
                             const int32_t* level, const uint8_t* node_mask,
                             const uint8_t* edgeless,
                             const uint16_t* grad_h) {
  const int S = d.S, D = d.D, hs = d.hs;
  const uint32_t all = S == 32 ? 0xffffffffu : (1u << S) - 1u;
  const EncMlp& prep = d.mlp[ENC_PREP];
  const EncMlp& msg = d.mlp[ENC_MSG];
  const EncMlp& upd = d.mlp[ENC_UPD];
  const uint32_t V =
      enc_load_job(b, d, job, x, adj, level, node_mask, edgeless, s);
  if (!V) return;
  const int E = enc_forward(b, d, s, true);
  const uint16_t* g = grad_h + job * S * D;
  const bool el = s.misc[1] != 0;
  for (int idx = b.t; idx < S * D; idx += b.nt) {
    const uint16_t gv = ((V >> (idx / D)) & 1u) ? g[idx] : (uint16_t)0;
    s.gh[idx] = el ? (uint16_t)0 : gv;
    s.ghin[idx] = el ? gv : (uint16_t)0;
  }
  ENC_SYNC();
  if (!el) {
    const uint16_t* m = s.Za + (msg.n - 1) * S * hs;
    for (int e = E - 1; e >= 0; --e) {  // the levels in reverse order
      const uint32_t P = enc_level_nodes(d, s, s.lvlist[e]);
      const uint16_t* hb = s.hist + e * S * D;
      mlp_fwd(b, msg, s.W, hb, D, all, S, s.Za, hs, d.slope);
      enc_aggregate(b, d, s, P, m);
      mlp_fwd(b, upd, s.W, s.agg, D, P, S, s.Zb, hs, d.slope);
      // h = where(P, h_init + update(agg), h): the cotangent to h_init
      // and the update's output on P, through to h elsewhere
      for (int idx = b.t; idx < S * D; idx += b.nt) {
        const int p = idx / D;
        const bool in_p = (P >> p) & 1u;
        s.G0[p * hs + idx - p * D] = in_p ? s.gh[idx] : (uint16_t)0;
        if (in_p) s.ghin[idx] = f2bf(bf2f(s.ghin[idx]) + bf2f(s.gh[idx]));
        s.gpass[idx] = in_p ? (uint16_t)0 : s.gh[idx];
      }
      ENC_SYNC();
      mlp_bwd(b, upd, s.W, s.agg, D, P, S, s.Zb, hs, s.G0, s.G1, s.gtmp, D,
              s.acc, d.slope);
      // the messages' cotangent: adj^T @ g_agg, summed over the parents in
      // order in f32 and rounded once
      for (int idx = b.t; idx < S * D; idx += b.nt) {
        const int c = idx / D, o = idx - c * D;
        float acc = 0.f;
        for (int p = 0; p < S; ++p)
          if (((P >> p) & 1u) && ((s.rows[p] >> c) & 1u))
            acc += bf2f(s.gtmp[p * D + o]);
        s.G0[c * hs + o] = f2bf(acc);
      }
      ENC_SYNC();
      mlp_bwd(b, msg, s.W, hb, D, all, S, s.Za, hs, s.G0, s.G1, s.gtmp, D,
              s.acc, d.slope);
      for (int idx = b.t; idx < S * D; idx += b.nt)
        s.gh[idx] = f2bf(bf2f(s.gpass[idx]) + bf2f(s.gtmp[idx]));
      ENC_SYNC();
    }
    // h0 = where(has_child, 0, update(h_init))
    mlp_fwd(b, upd, s.W, s.hin, D, all, S, s.Zb, hs, d.slope);
    for (int idx = b.t; idx < S * D; idx += b.nt) {
      const int p = idx / D;
      s.G0[p * hs + idx - p * D] = s.rows[p] ? (uint16_t)0 : s.gh[idx];
    }
    ENC_SYNC();
    mlp_bwd(b, upd, s.W, s.hin, D, all, S, s.Zb, hs, s.G0, s.G1, s.gtmp, D,
            s.acc, d.slope);
    for (int idx = b.t; idx < S * D; idx += b.nt)
      s.ghin[idx] = f2bf(bf2f(s.ghin[idx]) + bf2f(s.gtmp[idx]));
    ENC_SYNC();
  }
  // h_init = prep(x)
  mlp_fwd(b, prep, s.W, s.x, d.F, all, S, s.Zb, hs, d.slope);
  for (int idx = b.t; idx < S * D; idx += b.nt) {
    const int p = idx / D;
    s.G0[p * hs + idx - p * D] = s.ghin[idx];
  }
  ENC_SYNC();
  mlp_bwd(b, prep, s.W, s.x, d.F, all, S, s.Zb, hs, s.G0, s.G1, nullptr, 0,
          s.acc, d.slope);
}

// The dims from the MLP spec (per MLP: n, in[0..n-1], out[0..n-1]; prep,
// msg, update back to back); 0, or -1 for dims the kernels do not take.
static inline int enc_dims(EncDims* d, const int* spec, int B, int K, int S,
                           int F, int D, int nl, float slope) {
  int off = 0, hs = 0;
  const int* p = spec;
  for (int k = 0; k < 3; ++k) {
    EncMlp& m = d->mlp[k];
    m.n = p[0];
    if (m.n < 1 || m.n > ENC_MAX_LAYERS) return -1;
    for (int l = 0; l < m.n; ++l) {
      m.in[l] = p[1 + l];
      m.out[l] = p[1 + m.n + l];
      if (m.in[l] < 1 || m.out[l] < 1) return -1;
      if (l > 0 && m.in[l] != m.out[l - 1]) return -1;
      m.off[l] = off;
      off += m.in[l] * m.out[l] + m.out[l];
      hs = m.out[l] > hs ? m.out[l] : hs;
    }
    p += 1 + 2 * m.n;
  }
  if (S < 1 || S > ENC_MAX_S || F < 1 || D < 1 || B < 0 || K < 0) return -1;
  if (d->mlp[ENC_PREP].in[0] != F || d->mlp[ENC_PREP].out[d->mlp[0].n - 1] != D)
    return -1;
  for (int k = 1; k < 3; ++k)
    if (d->mlp[k].in[0] != D || d->mlp[k].out[d->mlp[k].n - 1] != D) return -1;
  if (nl < 0 || nl > S) return -1;
  d->S = S;
  d->F = F;
  d->D = D;
  d->nl = nl;
  d->K = K > 0 ? K : 1;
  d->wtotal = (off + 7) / 8 * 8;
  d->hs = hs;
  d->slope = slope;
  return 0;
}

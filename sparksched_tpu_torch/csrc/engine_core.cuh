// The arithmetic of the fused bulk event pass (`core._bulk_events_fused`,
// counterpart of `sparksched_tpu/env/core.py:1478-1740`) for ONE lane, as
// `__host__ __device__` inline functions: the duration model
// (`sample_executor_key_one`, `sample_task_duration_one`, counterparts of
// `workload/sampling.py`), the lane's setup (`bulk_events_lane_init`), its
// scan and stage epilogue (`bulk_events_fused_lane`) and its executor and
// lane outputs (`bulk_events_lane_finish`). `bulk_events.cu` runs a lane
// per block: every thread in the setup and the outputs, one thread in the
// scan, with a barrier between the parts.
//
// Under plain g++ (no `__CUDACC__`) the qualifiers become `inline` and the
// header compiles as C++: tests/test_torch_bulk_kernel.py builds it behind
// a C shim and holds every output against the plain torch pass. The host
// build takes its float32 expm1 from `ENGINE_HOST_EXPM1F` (default
// `std::expm1`), so a test can hand it the plain version's.
//
// Bit-equality with the plain version: every float expression is one
// rounded operation as torch computes it (`fmul_rn`, `fadd_rn`: no
// contraction into FMA on the card; the host build needs
// -ffp-contract=off); integer results are the dense masked sums' own,
// since each is a count. The uniforms are the plain version's table
// `split_uniform(rng, (L, N, 2))` at word (i * N + e) * 2 + k for step i,
// executor e, slot k, derived one pair per step (prng_core.cuh): under
// threefry from the lane's own second key, under rbg from the Philox
// stream of lane 0's second key at the lane's offset b * L * N * 2.

#pragma once

#include <cmath>
#include <cstdint>

#include "prng_core.cuh"

#if defined(__CUDACC__)
#define ENGINE_HD __host__ __device__ __forceinline__
#else
#define ENGINE_HD inline
#endif

#if !defined(__CUDA_ARCH__) && !defined(ENGINE_HOST_EXPM1F)
#define ENGINE_HOST_EXPM1F(x) std::expm1(x)
#endif

namespace engine_core {

constexpr int kBigSeq = 1 << 30;  // state.BIG_SEQ
constexpr int kWaveFresh = 0, kWaveFirst = 1, kWaveRest = 2;

ENGINE_HD float fmul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

ENGINE_HD float fadd_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

ENGINE_HD float expm1_f32(float x) {
#if defined(__CUDA_ARCH__)
  return expm1f(x);
#else
  return ENGINE_HOST_EXPM1F(x);
#endif
}

ENGINE_HD bool is_nan(float x) { return x != x; }

ENGINE_HD float inf_f32() {
#if defined(__CUDA_ARCH__)
  return __int_as_float(0x7f800000);
#else
  return INFINITY;
#endif
}

ENGINE_HD int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Every tensor the pass reads or writes, in the order of the pointer
// array that the wrapper (`kernels/bulk_events.py:ARG_ORDER`) passes.
// Inputs are the EnvState fields the pass reads ([B, ...], contiguous but
// for `rng`'s rows, bool as one byte), `enabled`, and the bank; outputs are the fields it
// writes, then k_rel and k_rdy.
#define BULK_EVENTS_POINTERS(X)                                             \
  X(const int64_t*, rng)                                                    \
  X(const uint8_t*, enabled)                                                \
  X(const float*, wall_time)                                                \
  X(const float*, time_limit)                                               \
  X(const int32_t*, seq_counter)                                            \
  X(const int32_t*, job_template)                                           \
  X(const float*, job_arrival_time)                                         \
  X(const int32_t*, job_arrival_seq)                                        \
  X(const uint8_t*, job_arrived)                                            \
  X(const int32_t*, job_saturated_stages)                                   \
  X(const uint8_t*, stage_exists)                                           \
  X(const int32_t*, stage_num_tasks)                                        \
  X(const int32_t*, stage_remaining)                                        \
  X(const int32_t*, stage_executing)                                        \
  X(const int32_t*, stage_completed_tasks)                                  \
  X(const float*, stage_duration)                                           \
  X(const uint8_t*, adj)                                                    \
  X(const uint8_t*, exec_at_common)                                         \
  X(const int32_t*, exec_job)                                               \
  X(const int32_t*, exec_stage)                                             \
  X(const uint8_t*, exec_moving)                                            \
  X(const int32_t*, exec_dst_job)                                           \
  X(const int32_t*, exec_dst_stage)                                         \
  X(const float*, exec_arrive_time)                                         \
  X(const int32_t*, exec_arrive_seq)                                        \
  X(const uint8_t*, exec_executing)                                         \
  X(const uint8_t*, exec_task_valid)                                        \
  X(const int32_t*, exec_task_stage)                                        \
  X(const float*, exec_finish_time)                                         \
  X(const int32_t*, exec_finish_seq)                                        \
  X(const uint8_t*, stage_sat)                                              \
  X(const int32_t*, unsat_parent_count)                                     \
  X(const int32_t*, incomplete_parent_count)                                \
  X(const int32_t*, commit_count)                                           \
  X(const int32_t*, moving_count)                                           \
  X(const uint8_t*, source_valid)                                           \
  X(const int32_t*, source_job)                                             \
  X(const int32_t*, source_stage)                                           \
  X(const int32_t*, bank_cnt)                                               \
  X(const void*, bank_dur)                                                  \
  X(const uint8_t*, bank_level_present)                                     \
  X(const int32_t*, bank_max_present)                                       \
  X(const float*, bank_rough_duration)                                      \
  X(const int32_t*, bank_itv_left_val)                                      \
  X(const int32_t*, bank_itv_right_val)                                     \
  X(const int32_t*, bank_itv_left_idx)                                      \
  X(const int32_t*, bank_itv_right_idx)                                     \
  X(const float*, bank_dur_scale)                                           \
  X(int64_t*, out_rng)                                                      \
  X(float*, out_wall_time)                                                  \
  X(int32_t*, out_seq_counter)                                              \
  X(int32_t*, out_job_saturated_stages)                                     \
  X(int32_t*, out_stage_remaining)                                          \
  X(int32_t*, out_stage_executing)                                          \
  X(int32_t*, out_stage_completed_tasks)                                    \
  X(float*, out_stage_duration)                                             \
  X(uint8_t*, out_exec_at_common)                                           \
  X(int32_t*, out_exec_job)                                                 \
  X(int32_t*, out_exec_stage)                                               \
  X(uint8_t*, out_exec_moving)                                              \
  X(float*, out_exec_arrive_time)                                           \
  X(uint8_t*, out_exec_executing)                                           \
  X(uint8_t*, out_exec_task_valid)                                          \
  X(int32_t*, out_exec_task_stage)                                          \
  X(float*, out_exec_finish_time)                                           \
  X(int32_t*, out_exec_finish_seq)                                          \
  X(uint8_t*, out_stage_sat)                                                \
  X(int32_t*, out_unsat_parent_count)                                       \
  X(int32_t*, out_moving_count)                                             \
  X(int32_t*, out_k_rel)                                                    \
  X(int32_t*, out_k_rdy)

// The sizes, in the order of the wrapper's dims array.
#define BULK_EVENTS_DIMS(X)                                                 \
  X(B)      /* lanes */                                                     \
  X(N)      /* executors */                                                 \
  X(J)      /* job slots */                                                 \
  X(S)      /* stage slots */                                               \
  X(W)      /* key words: 2 threefry, 4 rbg */                              \
  X(KS)     /* key row stride of `rng` (its words adjacent) */              \
  X(L)      /* scan length, max_events + N */                               \
  X(stop_at_limit)                                                          \
  X(dur_kind) /* bank.dur: 0 f32, 1 bf16, 2 int16, 3 int8 */                \
  X(BS)     /* bank stage slots */                                          \
  X(BL)     /* bank executor levels */                                      \
  X(BK)     /* bank bucket size */                                          \
  X(BI)     /* interval-table length */

#define ENGINE_FIELD(type, name) type name;
#define ENGINE_DIM(name) int name;

struct BulkArgs {
  BULK_EVENTS_POINTERS(ENGINE_FIELD)
  BULK_EVENTS_DIMS(ENGINE_DIM)
  float warmup_delay;
};

#define ENGINE_COUNT(...) +1
constexpr int kNumPointers = 0 BULK_EVENTS_POINTERS(ENGINE_COUNT);
constexpr int kNumDims = 0 BULK_EVENTS_DIMS(ENGINE_COUNT);

// BulkArgs from the wrapper's arrays (host side)
inline BulkArgs bulk_args_from(const int64_t* ptrs, const int64_t* dims,
                               float warmup_delay) {
  BulkArgs a;
  int i = 0;
#define ENGINE_UNPACK(type, name) a.name = reinterpret_cast<type>(ptrs[i++]);
  BULK_EVENTS_POINTERS(ENGINE_UNPACK)
#undef ENGINE_UNPACK
  i = 0;
#define ENGINE_UNPACK_DIM(name) a.name = (int)dims[i++];
  BULK_EVENTS_DIMS(ENGINE_UNPACK_DIM)
#undef ENGINE_UNPACK_DIM
  a.warmup_delay = warmup_delay;
  return a;
}

// ---------------------------------------------------------------------------
// the duration model (one draw)
// ---------------------------------------------------------------------------

// bank.dur read as the plain version reads it, by element type: float32 as
// is; bf16 widened; int codes widened, then expm1(code * dur_scale[t])
struct DurF32 {
  ENGINE_HD static float at(const void* p, long long i) {
    return static_cast<const float*>(p)[i];
  }
  static constexpr bool kNarrow = false;
};
struct DurBf16 {
  ENGINE_HD static float at(const void* p, long long i) {
    const uint32_t bits = (uint32_t)static_cast<const uint16_t*>(p)[i] << 16;
#if defined(__CUDA_ARCH__)
    return __uint_as_float(bits);
#else
    float x;
    std::memcpy(&x, &bits, sizeof x);
    return x;
#endif
  }
  static constexpr bool kNarrow = true;
};
template <class I>
struct DurInt {
  ENGINE_HD static float at(const void* p, long long i) {
    return (float)static_cast<const I*>(p)[i];
  }
  static constexpr bool kNarrow = true;
};

// `sample_executor_key` for one draw: the trace's executor-level index
// for `num_local` executors of stage (t, s), interpolating between the
// two levels that bracket it by u0
ENGINE_HD int sample_executor_key_one(const BulkArgs& a, float u0, int t,
                                      int s, int num_local) {
  const int nl = clampi(num_local, 0, a.BI - 1);
  const int lv = a.bank_itv_left_val[nl], rv = a.bank_itv_right_val[nl];
  const int rand_pt = 1 + (int)fmul_rn(u0, (float)(rv - lv));
  const bool use_left = (lv == rv) || (rand_pt <= num_local - lv);
  const int key_idx = use_left ? a.bank_itv_left_idx[nl]
                               : a.bank_itv_right_idx[nl];
  const int key_val = use_left ? lv : rv;
  const long long ts = (long long)t * a.BS + s;
  const bool present =
      a.bank_level_present[ts * a.BL + clampi(key_idx, 0, a.BL - 1)] &&
      key_val > 0;
  return present ? key_idx : a.bank_max_present[ts];
}

// `sample_task_duration` for one draw: the wave from the task's validity
// and stage, a bucket sample picked by u1, the stage's rough duration
// where the bucket is empty, plus the warm-up delay of a fresh executor
template <class Dur>
ENGINE_HD float sample_task_duration_one(const BulkArgs& a, float u0,
                                         float u1, int t, int s,
                                         int num_local, bool task_valid,
                                         bool same_stage) {
  const int li = clampi(sample_executor_key_one(a, u0, t, s, num_local), 0,
                        a.BL - 1);
  const long long ts = (long long)t * a.BS + s;
  const int* cnt = a.bank_cnt + ts * 3 * a.BL;  // [3, BL]
  const bool h_fresh = cnt[kWaveFresh * a.BL + li] > 0;
  const bool h_first = cnt[kWaveFirst * a.BL + li] > 0;
  const bool h_rest = cnt[kWaveRest * a.BL + li] > 0;
  int wave;
  if (!task_valid)
    wave = h_fresh ? kWaveFresh : kWaveFirst;
  else if (same_stage)
    wave = h_rest ? kWaveRest : (h_first ? kWaveFirst : kWaveFresh);
  else
    wave = h_first ? kWaveFirst : kWaveFresh;
  const bool warm = !task_valid && !h_fresh;
  const int c = cnt[wave * a.BL + li];
  const int n = c > 1 ? c : 1;
  const int draw = (int)fmul_rn(u1, (float)n);
  const int pick = draw < n - 1 ? draw : n - 1;
  float dur;
  if (c > 0) {
    dur = Dur::at(a.bank_dur,
                  (((ts * 3 + wave) * a.BL + li) * a.BK) + pick);
    if (Dur::kNarrow && a.bank_dur_scale != nullptr)
      dur = expm1_f32(fmul_rn(dur, a.bank_dur_scale[t]));
  } else {
    dur = a.bank_rough_duration[ts];
  }
  return fadd_rn(dur, warm ? a.warmup_delay : 0.0f);
}

// ---------------------------------------------------------------------------
// one lane of the pass
// ---------------------------------------------------------------------------

// executor flags in LaneWork::flags
constexpr uint8_t kArrived = 1, kStarted = 2;  // set by the scan
constexpr uint8_t kStartA = 4;   // an arrival starts a task (frontier)
constexpr uint8_t kJoinsA = 8;   // an arrival joins the live source pool
constexpr uint8_t kValidA = 16;  // the executor's task is valid
constexpr uint8_t kSameA = 32;   // ... and of its destination stage

// The lane's scratch: the executors' live event views and static arrival
// facts, the jobs' arrival events and templates, the live
// executors-per-job count, the touched stages (bitmaps over [J, S] and the
// list of their flat indices, each stage once) and the scan's results.
struct LaneWork {
  float* t_f;       // [N] finish times
  int32_t* sq_f;    // [N] finish seqs
  float* t_a;       // [N] arrival times
  int32_t* sq_a;    // [N] arrival seqs
  int32_t* fj;      // [N] each executor's next finish's job (clamped)
  int32_t* fs;      // [N] ... and stage
  int32_t* ej;      // [N] exec_job
  int32_t* dst;     // [N] the arrival's stage, clamped: job * S + stage
  float* t_job;     // [J] job arrival times, inf once arrived
  int32_t* q_job;   // [J] job arrival seqs
  int32_t* tpl;     // [J] job templates
  int32_t* jcnt;    // [J]
  uint32_t* launched;  // [ceil(J * S / 32)] stages that launched
  uint32_t* touched;   // [ceil(J * S / 32)] stages launched or arrived at
  int32_t* list;    // [L + N] the touched stages, in first-touch order
  int32_t* result;  // [4] wall time (bits), seq counter, k_rel, k_rdy
  uint8_t* flags;   // [N] kArrived | kStarted | k*A
};

ENGINE_HD int bitmap_words(const BulkArgs& a) { return (a.J * a.S + 31) / 32; }

// bytes of LaneWork for these sizes: 4-byte parts, then the flags
ENGINE_HD long long lane_work_bytes(const BulkArgs& a) {
  return 4LL * (8 * a.N + 4 * a.J + 2 * bitmap_words(a) + a.L + a.N + 4) +
         (a.N + 3) / 4 * 4;
}

ENGINE_HD LaneWork carve_lane_work(void* base, const BulkArgs& a) {
  LaneWork w;
  int32_t* p = static_cast<int32_t*>(base);  // 4-byte parts, in order
  const int N = a.N, J = a.J;
  w.t_f = reinterpret_cast<float*>(p);
  w.sq_f = p + N;
  w.t_a = reinterpret_cast<float*>(p + 2 * N);
  w.sq_a = p + 3 * N;
  w.fj = p + 4 * N;
  w.fs = p + 5 * N;
  w.ej = p + 6 * N;
  w.dst = p + 7 * N;
  w.t_job = reinterpret_cast<float*>(p + 8 * N);
  w.q_job = p + 8 * N + J;
  w.tpl = p + 8 * N + 2 * J;
  w.jcnt = p + 8 * N + 3 * J;
  w.launched = reinterpret_cast<uint32_t*>(p + 8 * N + 4 * J);
  w.touched = w.launched + bitmap_words(a);
  w.list = reinterpret_cast<int32_t*>(w.touched + bitmap_words(a));
  w.result = w.list + a.L + a.N;
  w.flags = reinterpret_cast<uint8_t*>(w.result + 4);
  return w;
}

// dst[0, nbytes) = src[0, nbytes), the share of thread `tid` of
// `nthreads`: 16-byte words where both sides are aligned
ENGINE_HD void copy_bytes(void* dst, const void* src, long long nbytes,
                          int tid, int nthreads) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  long long done = 0;
#if defined(__CUDA_ARCH__)
  if ((((uintptr_t)d | (uintptr_t)s) & 15) == 0) {
    const long long n16 = nbytes / 16;
    uint4* d16 = reinterpret_cast<uint4*>(d);
    const uint4* s16 = reinterpret_cast<const uint4*>(s);
    for (long long i = tid; i < n16; i += nthreads) d16[i] = s16[i];
    done = n16 * 16;
  }
#endif
  for (long long i = done + tid; i < nbytes; i += nthreads) d[i] = s[i];
}

// Thread `tid` of `nthreads`' share of lane b's setup: every output field
// the pass writes starts as the lane's input (the pass changes a few
// entries of each), the scratch from the inputs. Each thread writes
// entries no other thread writes; the caller syncs before
// `bulk_events_fused_lane`.
ENGINE_HD void bulk_events_lane_init(const BulkArgs& a, int b,
                                     const LaneWork& w, int tid,
                                     int nthreads) {
  const int N = a.N, J = a.J, S = a.S;
  const long long js = (long long)J * S, bjs = b * js;
  copy_bytes(a.out_stage_remaining + bjs, a.stage_remaining + bjs, 4 * js,
             tid, nthreads);
  copy_bytes(a.out_stage_executing + bjs, a.stage_executing + bjs, 4 * js,
             tid, nthreads);
  copy_bytes(a.out_stage_completed_tasks + bjs,
             a.stage_completed_tasks + bjs, 4 * js, tid, nthreads);
  copy_bytes(a.out_stage_duration + bjs, a.stage_duration + bjs, 4 * js, tid,
             nthreads);
  copy_bytes(a.out_stage_sat + bjs, a.stage_sat + bjs, js, tid, nthreads);
  copy_bytes(a.out_unsat_parent_count + bjs, a.unsat_parent_count + bjs,
             4 * js, tid, nthreads);
  copy_bytes(a.out_moving_count + bjs, a.moving_count + bjs, 4 * js, tid,
             nthreads);
  const long long bj = (long long)b * J;
  copy_bytes(a.out_job_saturated_stages + bj, a.job_saturated_stages + bj,
             4LL * J, tid, nthreads);
  for (int j = tid; j < J; j += nthreads) {
    w.t_job[j] = a.job_arrived[bj + j] ? inf_f32() : a.job_arrival_time[bj + j];
    w.q_job[j] = a.job_arrival_seq[bj + j];
    w.tpl[j] = a.job_template[bj + j];
    w.jcnt[j] = 0;
  }
  for (int i = tid; i < bitmap_words(a); i += nthreads) {
    w.launched[i] = 0u;
    w.touched[i] = 0u;
  }
  const long long bn = (long long)b * N;
  const bool src_valid = a.source_valid[b];
  const int src_job = a.source_job[b], src_stage = a.source_stage[b];
  for (int e = tid; e < N; e += nthreads) {
    const long long x = bn + e;
    w.t_f[e] = a.exec_finish_time[x];
    w.sq_f[e] = a.exec_finish_seq[x];
    w.t_a[e] = a.exec_arrive_time[x];
    w.sq_a[e] = a.exec_arrive_seq[x];
    w.ej[e] = a.exec_job[x];
    w.fj[e] = clampi(a.exec_job[x], 0, J - 1);
    w.fs[e] = clampi(a.exec_task_stage[x], 0, S - 1);
    // the arrival's static facts on the input state: it starts a task
    // where its (clamped) destination is on the frontier
    const int dj = a.exec_dst_job[x], ds0 = a.exec_dst_stage[x];
    const int d = clampi(dj, 0, J - 1) * S + clampi(ds0, 0, S - 1);
    w.dst[e] = d;
    const bool start = a.stage_exists[bjs + d] &&
                       !(a.stage_completed_tasks[bjs + d] >=
                         a.stage_num_tasks[bjs + d]) &&
                       a.incomplete_parent_count[bjs + d] == 0;
    const bool joins = src_valid && dj == src_job &&
                       (start ? ds0 == src_stage : src_stage == -1);
    w.flags[e] = (start ? kStartA : 0) | (joins ? kJoinsA : 0) |
                 (a.exec_task_valid[x] ? kValidA : 0) |
                 (a.exec_task_stage[x] == ds0 ? kSameA : 0);
  }
}

ENGINE_HD bool test_set(uint32_t* bits, int i) {
  const uint32_t m = 1u << (i & 31);
  const bool was = (bits[i >> 5] & m) != 0;
  bits[i >> 5] |= m;
  return was;
}

ENGINE_HD bool test_bit(const uint32_t* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// The lexicographic (time, seq) minimum of n events: (tmin, smin, the
// first event at both). False when a time is NaN: torch's amin is NaN
// then, and no event of the step is finite.
ENGINE_HD bool event_min(const float* t, const int32_t* sq, int n,
                         float& tmin, int& smin, int& at) {
  tmin = inf_f32();
  for (int e = 0; e < n; ++e) {
    const float x = t[e];
    if (is_nan(x)) return false;
    if (x < tmin) tmin = x;
  }
  smin = kBigSeq;
  at = -1;
  for (int e = 0; e < n; ++e)
    if (t[e] == tmin && sq[e] < smin) {
      smin = sq[e];
      at = e;
    }
  return true;
}

ENGINE_HD float bits_float(int32_t x) {
#if defined(__CUDA_ARCH__)
  return __int_as_float(x);
#else
  float f;
  std::memcpy(&f, &x, sizeof f);
  return f;
#endif
}

ENGINE_HD int32_t float_bits(float f) {
#if defined(__CUDA_ARCH__)
  return __float_as_int(f);
#else
  int32_t x;
  std::memcpy(&x, &f, sizeof x);
  return x;
#endif
}

// Lane b's scan and its [J, S] epilogue, on one thread, after
// `bulk_events_lane_init` (see the file comment and
// `core._bulk_events_fused_ref`); its per-lane results go to w.result for
// `bulk_events_lane_finish`.
template <class Dur>
ENGINE_HD void bulk_events_fused_lane(const BulkArgs& a, int b,
                                      const LaneWork& w) {
  const int N = a.N, J = a.J, S = a.S;
  const long long bjs = (long long)b * J * S;
  int32_t* rem = a.out_stage_remaining + bjs;

  for (int e = 0; e < N; ++e)
    if (w.ej[e] >= 0 && w.ej[e] < J) ++w.jcnt[w.ej[e]];

  // job arrivals: the only competitor kind (never consumed here)
  float jt = inf_f32();
  bool jt_nan = false;
  for (int j = 0; j < J; ++j) {
    if (is_nan(w.t_job[j])) jt_nan = true;
    else if (w.t_job[j] < jt) jt = w.t_job[j];
  }
  int jseq = kBigSeq;
  for (int j = 0; j < J; ++j)
    if (w.t_job[j] == jt && w.q_job[j] < jseq) jseq = w.q_job[j];

  // the uniforms: under threefry the lane's second key, under rbg the
  // Philox key of lane 0's second key and this lane's stream offset
  uint32_t sub[4] = {0u, 0u, 0u, 0u};
  if (a.W == 4) prng_core::rbg_sub_key(a.rng, sub);
  else prng_core::split_tf_sub_key(a.rng + (long long)b * a.KS, sub[0],
                                   sub[1]);
  const uint64_t lane_words = (uint64_t)b * a.L * N * 2;

  const float limit = a.time_limit[b];
  int counter = a.seq_counter[b];
  float wall = a.wall_time[b];
  int k_rel = 0, k_rdy = 0, n_list = 0;
  bool crossed = false;
  const bool active = a.enabled[b] && !jt_nan;

  for (int i = 0; active && i < a.L; ++i) {
    float ftmin, atmin;
    int fsmin, asmin, fe, ae;
    if (!event_min(w.t_f, w.sq_f, N, ftmin, fsmin, fe) ||
        !event_min(w.t_a, w.sq_a, N, atmin, asmin, ae))
      break;  // a NaN time: no event is finite
    const bool is_fin =
        (ftmin < atmin) || ((ftmin == atmin) && (fsmin < asmin));
    const float tmin = is_fin ? ftmin : atmin;
    if (!(tmin < inf_f32() && tmin > -inf_f32())) break;  // no event
    const int smin = is_fin ? fsmin : asmin;
    const bool before_job = (tmin < jt) || ((tmin == jt) && (smin < jseq));
    const int e = is_fin ? fe : ae;
    if (e < 0) break;  // no event at the least time has a seq below BIG_SEQ
    const int tjs = is_fin ? w.fj[e] * S + w.fs[e] : w.dst[e];
    const int tj = tjs / S, ts = tjs % S;
    bool ok = before_job && rem[tjs] > 0;
    if (a.stop_at_limit) {
      ok = ok && !crossed;
      crossed = crossed || (ok && tmin >= limit);
    }
    if (!ok) break;

    const uint8_t fl = w.flags[e];
    const bool start_a = !is_fin && (fl & kStartA);
    const bool launch = is_fin || start_a;
    if (launch) {
      const uint64_t word = ((uint64_t)i * N + e) * 2;
      float u0, u1;
      if (a.W == 4) {
        prng_core::uniform_rbg_pair(sub, lane_words + word, u0, u1);
      } else {
        u0 = prng_core::uniform_tf_word(sub[0], sub[1], word);
        u1 = prng_core::uniform_tf_word(sub[0], sub[1], word + 1);
      }
      const int nl = w.jcnt[tj] + (is_fin ? 0 : 1);
      const bool tv = is_fin || (fl & kValidA);
      const bool ss = is_fin || (fl & kSameA);
      const float dur = sample_task_duration_one<Dur>(a, u0, u1, w.tpl[tj],
                                                      ts, nl, tv, ss);
      w.t_f[e] = fadd_rn(tmin, dur);
      w.sq_f[e] = counter;
      counter += 1;
      rem[tjs] -= 1;
      a.out_stage_duration[bjs + tjs] = dur;
      test_set(w.launched, tjs);
      if (!test_set(w.touched, tjs)) w.list[n_list++] = tjs;
    }
    if (is_fin) {
      a.out_stage_completed_tasks[bjs + tjs] += 1;
      k_rel += 1;
    } else {
      w.t_a[e] = inf_f32();
      w.flags[e] |= kArrived;
      w.jcnt[tj] += 1;
      k_rdy += 1;
      if (start_a) {
        w.fj[e] = tj;
        w.fs[e] = ts;
        w.flags[e] |= kStarted;
      }
    }
    wall = tmin;
    if (!is_fin && (fl & kJoinsA)) break;  // consumed, then the run ends
  }

  // [J,S] counts of the consumed arrivals (static, unclamped destinations)
  const long long bn = (long long)b * N;
  for (int e = 0; e < N; ++e) {
    if (!(w.flags[e] & kArrived)) continue;
    const int dj = a.exec_dst_job[bn + e], ds0 = a.exec_dst_stage[bn + e];
    if (dj < 0 || dj >= J || ds0 < 0 || ds0 >= S) continue;
    const int d = dj * S + ds0;
    a.out_moving_count[bjs + d] -= 1;
    if (w.flags[e] & kStarted) a.out_stage_executing[bjs + d] += 1;
    if (!test_set(w.touched, d)) w.list[n_list++] = d;
  }

  // each touched stage once: full launch, saturation-cache refresh and its
  // children's unsaturated-parent counts
  for (int k = 0; k < n_list; ++k) {
    const int d = w.list[k];
    const int j = d / S;
    if (test_bit(w.launched, d) && rem[d] == 0)
      a.out_job_saturated_stages[(long long)b * J + j] += 1;
    const int demand =
        rem[d] - a.out_moving_count[bjs + d] - a.commit_count[bjs + d];
    const bool sat_new = demand <= 0;
    if (a.stage_exists[bjs + d]) {
      const int delta = (int)sat_new - (int)(a.stage_sat[bjs + d] != 0);
      if (delta != 0) {
        const uint8_t* adj_row = a.adj + (bjs + d) * S;
        int32_t* unsat = a.out_unsat_parent_count + bjs + (long long)j * S;
        for (int c = 0; c < S; ++c)
          if (adj_row[c]) unsat[c] -= delta;
      }
    }
    a.out_stage_sat[bjs + d] = sat_new ? 1 : 0;
  }
  w.result[0] = float_bits(wall);
  w.result[1] = counter;
  w.result[2] = k_rel;
  w.result[3] = k_rdy;
}

// Thread `tid` of `nthreads`' share of lane b's executor and lane outputs,
// after `bulk_events_fused_lane` (the caller syncs between them).
ENGINE_HD void bulk_events_lane_finish(const BulkArgs& a, int b,
                                       const LaneWork& w, int tid,
                                       int nthreads) {
  const long long bn = (long long)b * a.N;
  for (int e = tid; e < a.N; e += nthreads) {
    const long long x = bn + e;
    const bool arrived = w.flags[e] & kArrived;
    const bool started = w.flags[e] & kStarted;
    a.out_exec_finish_time[x] = w.t_f[e];
    a.out_exec_finish_seq[x] = w.sq_f[e];
    a.out_exec_arrive_time[x] = w.t_a[e];
    a.out_exec_moving[x] = a.exec_moving[x] && !arrived;
    a.out_exec_at_common[x] = a.exec_at_common[x] && !arrived;
    a.out_exec_job[x] = arrived ? a.exec_dst_job[x] : a.exec_job[x];
    a.out_exec_stage[x] = arrived ? (started ? a.exec_dst_stage[x] : -1)
                                  : a.exec_stage[x];
    a.out_exec_task_valid[x] = arrived ? started : a.exec_task_valid[x];
    a.out_exec_executing[x] = a.exec_executing[x] || started;
    a.out_exec_task_stage[x] =
        started ? a.exec_dst_stage[x] : a.exec_task_stage[x];
  }
  // the next key where the lane bulked (a 2-word half a thread), else its
  // own key
  const int64_t* key = a.rng + (long long)b * a.KS;
  int64_t* next = a.out_rng + (long long)b * a.W;
  const bool bulked = w.result[2] + w.result[3] > 0;
  for (int h = tid; h < a.W; h += nthreads) {
    if (!bulked) next[h] = key[h];
    else if (h % 2 == 0) prng_core::split_next_key(key + h, 2, next + h);
  }
  if (tid == 0) {
    a.out_wall_time[b] = bits_float(w.result[0]);
    a.out_seq_counter[b] = w.result[1];
    a.out_k_rel[b] = w.result[2];
    a.out_k_rdy[b] = w.result[3];
  }
}

}  // namespace engine_core

// The arithmetic of the fused bulk event pass (`core._bulk_events_fused`,
// counterpart of `sparksched_tpu/env/core.py:1478-1740`) for ONE lane, in
// the parts that `bulk_events.cu` runs on a lane's block: the setup
// (`bulk_events_lane_init` over the setup's threads, `bulk_events_lane_keys`
// and `bulk_events_lane_jobs` on a warp each, then `bulk_events_lane_elect`
// and `bulk_events_lane_slots`), the scan on one warp with the duration
// model (`bulk_events_scan`: counterparts of `workload/sampling.py`'s
// `sample_executor_key` and `sample_task_duration`) beside the producers
// of its uniforms (`bulk_events_produce`) and the copy of the written
// fields (`bulk_events_copy`), and the lane's outputs
// (`bulk_events_lane_finish`).
//
// Every stage the pass can launch at or arrive at is one of 2N candidates
// (each executor's finish target and its arrival's destination), so the
// setup loads each candidate's stage facts and bank rows once into shared
// memory and elects one overlay slot per distinct stage. The scan never
// reads an output: while the copy runs it keeps each touched stage's live
// remaining count, completed, moving and executing deltas and last
// duration in its slot, and the finish writes the touched slots over the
// copy. Each step's (time, seq) minimum over the executors' finish and
// arrival events is a warp reduction: lane l takes the minimum of
// executors l, l + 32, ..., five xor-shuffle rounds combine the 32
// partials (`EventArg`, `combine`). Meanwhile each lane works out what a
// launch of its own least event of each kind would draw (`lane_cand`:
// the duration from the shared-memory rows and the step's uniforms, which
// the producer warps derived ahead of the scan, and its one global load,
// the bucket sample), so the winner's comes by one shuffle from its lane.
//
// The warp code is written over a small lane abstraction (`Lanes`,
// `each_lane`, `one_lane`, `butterfly`, `any_lane`, the shuffle picks):
// on the card a `Lanes<T>` is the lane's own register and the collectives
// are `__shfl_*_sync` / `__any_sync`; under plain g++ (no `__CUDACC__`) it
// is an array of 32 lanes that the same butterfly runs over, the atomics
// plain read-modify-writes, and the scan makes each row of uniforms itself
// (`await_row`). tests/test_torch_bulk_kernel.py builds the header so
// behind a C shim and holds every output against the plain torch pass.
// The host build takes its float32 expm1 from
// `ENGINE_HOST_EXPM1F` (default `std::expm1`), so a test can hand it the
// plain version's.
//
// Bit-equality with the plain version: every float expression is one
// rounded operation as torch computes it (`fmul_rn`, `fadd_rn`: no
// contraction into FMA on the card; the host build needs
// -ffp-contract=off); integer results are the dense masked sums' own,
// since each is a count (so their atomic order does not matter). The
// reduced minimum is the serial scan's: a NaN anywhere ends the run, the
// first index wins among equal (time, seq), the time's bits are those of
// the first index whose time compares equal to the least, and no event is
// chosen where the least seq at the least time is >= BIG_SEQ. The uniforms
// are the plain version's table `split_uniform(rng, (L, N, 2))` at word
// (i * N + e) * 2 + k for step i, executor e, slot k, derived one pair per
// step (prng_core.cuh): under threefry from the lane's own second key,
// under rbg from the Philox stream of lane 0's second key at the lane's
// offset b * L * N * 2.

#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#include "prng_core.cuh"

#if defined(__CUDACC__)
#define ENGINE_HD __host__ __device__ __forceinline__
#define ENGINE_WARP __device__ __forceinline__
#define ENGINE_UNROLL _Pragma("unroll")
#else
#define ENGINE_HD inline
#define ENGINE_WARP inline
#define ENGINE_UNROLL
#endif

#if !defined(__CUDA_ARCH__) && !defined(ENGINE_HOST_EXPM1F)
#define ENGINE_HOST_EXPM1F(x) std::expm1(x)
#endif

namespace engine_core {

constexpr int kBigSeq = 1 << 30;  // state.BIG_SEQ
constexpr int kWaveFresh = 0, kWaveFirst = 1, kWaveRest = 2;
constexpr int kWarp = 32;
constexpr int kMaxLevels = 32;  // BL: a stage's presence row is one word
constexpr int kUnrolled = 4;    // executors a lane takes unrolled (N <= 128)
constexpr int kRing = 8;        // rows of uniforms produced ahead of the scan
constexpr int kProducers = 3 * kWarp;  // threads that produce them

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

// a word another warp of the block writes while this one waits on it
ENGINE_HD int32_t vload(const int32_t* p) {
  return *static_cast<const volatile int32_t*>(p);
}

ENGINE_HD void vstore(int32_t* p, int32_t x) {
  *static_cast<volatile int32_t*>(p) = x;
}

ENGINE_HD void fence_block() {
#if defined(__CUDA_ARCH__)
  __threadfence_block();
#endif
}

// an input read through the read-only path (the pass never writes its
// inputs), so the loads of a setup round are in flight together
template <class T>
ENGINE_HD T ld(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
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

// sizes the lane code takes (a presence row fits one word)
inline bool bulk_args_valid(const BulkArgs& a) {
  return a.B >= 0 && a.N >= 1 && a.J >= 1 && a.S >= 1 &&
         (a.W == 2 || a.W == 4) && a.L >= 0 && a.BI >= 1 && a.BL >= 1 &&
         a.BL <= kMaxLevels && a.BK >= 1;
}

// ---------------------------------------------------------------------------
// the lane abstraction: one warp on the card, 32 array entries under g++
// ---------------------------------------------------------------------------

#if defined(__CUDACC__)

// a value per lane: the lane's own copy
template <class T>
struct Lanes {
  T v;
  ENGINE_WARP T& operator[](int) { return v; }
  ENGINE_WARP const T& operator[](int) const { return v; }
  // after a butterfly every lane holds the same value
  ENGINE_WARP const T& uniform() const { return v; }
};

ENGINE_WARP int lane_id() { return (int)(threadIdx.x & (kWarp - 1)); }

// f(l) on each lane l
template <class F>
ENGINE_WARP void each_lane(F f) {
  f(lane_id());
}

// f() once for the warp (a write of values every lane holds)
template <class F>
ENGINE_WARP void one_lane(F f) {
  if (lane_id() == 0) f();
}

ENGINE_WARP void sync_lanes() { __syncwarp(); }

ENGINE_WARP bool any_lane(const Lanes<bool>& x) {
  return __any_sync(0xffffffffu, x.v);
}

ENGINE_WARP int32_t shfl_xor(int32_t x, int m) {
  return __shfl_xor_sync(0xffffffffu, x, m);
}

ENGINE_WARP float shfl_xor(float x, int m) {
  return __shfl_xor_sync(0xffffffffu, x, m);
}

ENGINE_WARP int32_t shfl(int32_t x, int src) {
  return __shfl_sync(0xffffffffu, x, src);
}

ENGINE_WARP float shfl(float x, int src) {
  return __shfl_sync(0xffffffffu, x, src);
}

// lane `src`'s value, on every lane
template <class T>
ENGINE_WARP T from_lane(const Lanes<T>& x, int src) {
  return shfl(x.v, src);
}

// x <- combine(x, the partner's x) over partners 16, 8, 4, 2, 1: every
// lane ends with the combine of all 32 (combine is commutative and
// associative)
template <class T>
ENGINE_WARP void butterfly(Lanes<T>& x) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1) x.v = combine(x.v, shfl_xor(x.v, m));
}

ENGINE_WARP int32_t atomic_add(int32_t* p, int32_t v) { return atomicAdd(p, v); }

ENGINE_WARP uint32_t atomic_or(uint32_t* p, uint32_t m) {
  return atomicOr(p, m);
}

#else  // the host build: the 32 lanes as an array, run in order

template <class T>
struct Lanes {
  T v[kWarp];
  T& operator[](int l) { return v[l]; }
  const T& operator[](int l) const { return v[l]; }
  const T& uniform() const { return v[0]; }
};

template <class F>
inline void each_lane(F f) {
  for (int l = 0; l < kWarp; ++l) f(l);
}

template <class F>
inline void one_lane(F f) {
  f();
}

inline void sync_lanes() {}

inline bool any_lane(const Lanes<bool>& x) {
  bool r = false;
  for (int l = 0; l < kWarp; ++l) r = r || x.v[l];
  return r;
}

template <class T>
inline T from_lane(const Lanes<T>& x, int src) {
  return x.v[src];
}

template <class T>
inline void butterfly(Lanes<T>& x) {
  for (int m = kWarp / 2; m > 0; m >>= 1) {
    T y[kWarp];
    for (int l = 0; l < kWarp; ++l) y[l] = combine(x.v[l], x.v[l ^ m]);
    for (int l = 0; l < kWarp; ++l) x.v[l] = y[l];
  }
}

inline int32_t atomic_add(int32_t* p, int32_t v) {
  const int32_t old = *p;
  *p += v;
  return old;
}

inline uint32_t atomic_or(uint32_t* p, uint32_t m) {
  const uint32_t old = *p;
  *p |= m;
  return old;
}

#endif

// ---------------------------------------------------------------------------
// the (time, seq) minimum as a warp reduction
// ---------------------------------------------------------------------------

constexpr int32_t kNoIndex = 0x7fffffff;

// A partial minimum over some events: the least time `t` and the first
// index `first` whose time compares equal to it (its bits are `t`'s; the
// initial +inf has none), and among the events at that time the least seq
// and the first index holding it (`at`).
struct EventArg {
  float t;
  int32_t first;
  int32_t seq;
  int32_t at;
};

// the minimum of two partials, by predicates and selects (no branch: the
// warp stays converged through the butterfly)
ENGINE_HD EventArg combine(const EventArg& x, const EventArg& y) {
  const bool xl = x.t < y.t, yl = y.t < x.t;
  const bool y_first = (!xl) & (yl | (y.first < x.first));
  const bool y_seq =
      (!xl) & (yl | (y.seq < x.seq) | ((y.seq == x.seq) & (y.at < x.at)));
  return {y_first ? y.t : x.t, y_first ? y.first : x.first,
          y_seq ? y.seq : x.seq, y_seq ? y.at : x.at};
}

// event e (time x, seq q) into a partial minimum, where `in`
ENGINE_HD void take_event(EventArg& r, bool& nan, float x, int32_t q, int e,
                          bool in) {
  const bool less = in & (x < r.t);
  const bool seq = less | (in & (x == r.t) & (q < r.seq));
  nan = nan | (in & is_nan(x));
  r.t = less ? x : r.t;
  r.first = less ? e : r.first;
  r.seq = seq ? q : r.seq;
  r.at = seq ? e : r.at;
}

// lane l's share of n events (indices l, l + 32, ..., in order): its
// partial minimum, `nan` set where a time is NaN (skipped here; the
// caller ends the run)
ENGINE_HD EventArg lane_event_arg(const float* t, const int32_t* sq, int n,
                                  int l, bool& nan) {
  EventArg r = {inf_f32(), kNoIndex, kNoIndex, kNoIndex};
  ENGINE_UNROLL
  for (int k = 0; k < kUnrolled; ++k) {  // predicated: no branch
    const int e = l + k * kWarp;
    const int ec = e < n ? e : 0;
    take_event(r, nan, t[ec], sq[ec], e, e < n);
  }
  for (int e = l + kUnrolled * kWarp; e < n; e += kWarp)
    take_event(r, nan, t[e], sq[e], e, true);
  return r;
}

// (tmin, smin, the event) of a reduced minimum: smin is capped at
// BIG_SEQ, and no event is chosen (-1) where no seq at tmin is below it
ENGINE_HD void event_result(const EventArg& r, float& tmin, int& smin,
                            int& at) {
  tmin = r.t;
  smin = r.seq < kBigSeq ? r.seq : kBigSeq;
  at = r.seq < kBigSeq ? r.at : -1;
}

// a step's two minima: the executors' finishes and their arrivals
struct StepMin {
  EventArg f, a;
};

ENGINE_HD StepMin combine(const StepMin& x, const StepMin& y) {
  return {combine(x.f, y.f), combine(x.a, y.a)};
}

// What a lane knows of its own least event of a kind before the warp
// knows the winner (the winner is the least event of its owner lane): its
// target stage, that stage's live remaining count and overlay slot, its
// candidate row, and the duration a launch of it would draw.
struct Cand {
  float dur;
  int32_t stage, rem, slot, row;
};

#if defined(__CUDACC__)
ENGINE_WARP EventArg shfl_xor(const EventArg& x, int m) {
  return {shfl_xor(x.t, m), shfl_xor(x.first, m), shfl_xor(x.seq, m),
          shfl_xor(x.at, m)};
}

ENGINE_WARP StepMin shfl_xor(const StepMin& x, int m) {
  return {shfl_xor(x.f, m), shfl_xor(x.a, m)};
}

ENGINE_WARP Cand shfl(const Cand& c, int src) {
  return {shfl(c.dur, src), shfl(c.stage, src), shfl(c.rem, src),
          shfl(c.slot, src), shfl(c.row, src)};
}
#endif

// ---------------------------------------------------------------------------
// the duration model's inputs
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
    return bits_float((int32_t)bits);
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

// the pair of uniforms a step consumes: under threefry from the lane's
// second key, under rbg from the Philox stream of lane 0's second key at
// the lane's offset
struct StepDraw {
  uint32_t sub[4];
  bool rbg;
  uint64_t lane_words;
  ENGINE_HD void pair(uint64_t word, float& u0, float& u1) const {
    if (rbg) {
      prng_core::uniform_rbg_pair(sub, lane_words + word, u0, u1);
    } else {
      u0 = prng_core::uniform_tf_word(sub[0], sub[1], word);
      u1 = prng_core::uniform_tf_word(sub[0], sub[1], word + 1);
    }
  }
};

// ---------------------------------------------------------------------------
// one lane of the pass
// ---------------------------------------------------------------------------

// executor flags in LaneWork::flags
constexpr int32_t kArrived = 1, kStarted = 2;  // set by the scan
constexpr int32_t kStartA = 4;   // an arrival starts a task (frontier)
constexpr int32_t kJoinsA = 8;   // an arrival joins the live source pool
constexpr int32_t kValidA = 16;  // the executor's task is valid
constexpr int32_t kSameA = 32;   // ... and of its destination stage
constexpr int32_t kDstIn = 64;   // the destination (job, stage) is in range
constexpr int32_t kMoving = 128, kAtCommon = 256, kExecuting = 512;

// stage facts in LaneWork::rc_facts
constexpr int32_t kExists = 1, kSat = 2;

// a slot's state in LaneWork::ov_flags
constexpr uint32_t kTouched = 1, kLaunched = 2;

// the lane's scalars in LaneWork::scal
enum Scal {
  kOutWall, kOutCounter, kKRel, kKRdy,  // the scan's
  kEnabled, kLimit, kCounter, kWall, kJobT, kJobSeq, kJobNan,
  kReady, kTaken, kStop, kGo,  // the uniforms' ring: rows made, used
  kSub,        // [4] the uniforms' key
  kNext = kSub + 4,  // [4] the next key where the lane bulks
  kNumScal = kNext + 4
};

// The lane's scratch in shared memory. Every stage the pass can launch at
// or arrive at is the target of one of 2N candidates: candidate e is
// executor e's next finish's stage, candidate N + e its arrival's (an
// arrival that starts a task moves the executor's finish there), so the
// setup loads each candidate's bank rows and stage facts once. Then the
// executors' live event views and output inputs, the live executors per
// job, the bank's interval tables, the overlay and the lane's scalars.
// The overlay has a slot for each distinct candidate stage, the first
// candidate of that stage that the setup elected: the scan keeps the
// stage's live remaining count, deltas and last duration there, and the
// outputs are written for the slots a launch or an arrival touched.
struct LaneWork {
  float* t_f;       // [N] finish times
  int32_t* sq_f;    // [N] finish seqs
  float* t_a;       // [N] arrival times
  int32_t* sq_a;    // [N] arrival seqs
  int32_t* frow;    // [N] the candidate of the executor's next finish
  int32_t* ej;      // [N] exec_job
  int32_t* ex_stage;  // [N] exec_stage
  int32_t* ex_dj;     // [N] exec_dst_job
  int32_t* ex_ds;     // [N] exec_dst_stage
  int32_t* ex_ts;     // [N] exec_task_stage
  int32_t* flags;     // [N] kArrived | kStarted | k*A | kDstIn | ...
  int32_t* rc_stage;  // [2N] the candidate's stage, clamped: job * S + stage
  int32_t* rc_rem;    // [2N] its input stage_remaining
  int32_t* rc_ts;     // [2N] its bank row: template * BS + stage
  int32_t* rc_present;  // [2N] bank.level_present's row as bits
  int32_t* rc_mp;       // [2N] bank.max_present
  float* rc_rough;      // [2N] bank.rough_duration
  float* rc_scale;      // [2N] bank.dur_scale of its template
  int32_t* rc_moving;     // [2N] its input moving_count
  int32_t* rc_completed;  // [2N] ... stage_completed_tasks
  int32_t* rc_executing;  // [2N] ... stage_executing
  int32_t* rc_commit;     // [2N] ... commit_count
  int32_t* rc_facts;      // [2N] kExists | kSat
  int32_t* rc_cnt;        // [2N, 3, BL] bank.cnt's rows
  float* t_job;     // [J] job arrival times, inf once arrived
  int32_t* q_job;   // [J] job arrival seqs
  int32_t* jcnt;    // [J] live executors per job
  int32_t* itv_lv;  // [BI] bank.itv_left_val
  int32_t* itv_rv;  // [BI] bank.itv_right_val
  int32_t* itv_li;  // [BI] bank.itv_left_idx
  int32_t* itv_ri;  // [BI] bank.itv_right_idx
  uint32_t* elected;  // [ceil(J * S / 32)] stages with a slot (setup)
  int32_t* slot;      // [J * S] an elected stage's slot (setup)
  int32_t* cand_slot;  // [2N] the slot of the candidate's stage
  int32_t* ov_rem;     // [2N] a slot's live remaining count
  int32_t* ov_comp;    // [2N] its completed-task delta
  int32_t* ov_mov;     // [2N] its moving_count delta
  int32_t* ov_exe;     // [2N] its stage_executing delta
  float* ov_dur;       // [2N] its last duration
  uint32_t* ov_flags;  // [2N] kTouched | kLaunched
  float* uni0;         // [kRing, N] the uniforms of step i at row i % kRing
  float* uni1;         // [kRing, N] ... the second of each pair
  int32_t* scal;      // [kNumScal]
};

ENGINE_HD int bitmap_words(const BulkArgs& a) { return (a.J * a.S + 31) / 32; }

// the 4-byte words of LaneWork for these sizes
ENGINE_HD long long lane_work_words(const BulkArgs& a) {
  const long long n = a.N, c = 2LL * a.N;
  return 11 * n + c * (19 + 3LL * a.BL) + 3LL * a.J +
         4LL * a.BI + bitmap_words(a) + (long long)a.J * a.S +
         2LL * kRing * n + kNumScal;
}

ENGINE_HD long long lane_work_bytes(const BulkArgs& a) {
  return 4 * lane_work_words(a);
}

ENGINE_HD LaneWork carve_lane_work(void* base, const BulkArgs& a) {
  LaneWork w;
  int32_t* p = static_cast<int32_t*>(base);  // 4-byte parts, in order
  auto take = [&p](long long n) {
    int32_t* q = p;
    p += n;
    return q;
  };
  auto takef = [&take](long long n) {
    return reinterpret_cast<float*>(take(n));
  };
  const long long N = a.N, C = 2LL * a.N;
  w.t_f = takef(N);
  w.sq_f = take(N);
  w.t_a = takef(N);
  w.sq_a = take(N);
  w.frow = take(N);
  w.ej = take(N);
  w.ex_stage = take(N);
  w.ex_dj = take(N);
  w.ex_ds = take(N);
  w.ex_ts = take(N);
  w.flags = take(N);
  w.rc_stage = take(C);
  w.rc_rem = take(C);
  w.rc_ts = take(C);
  w.rc_present = take(C);
  w.rc_mp = take(C);
  w.rc_rough = takef(C);
  w.rc_scale = takef(C);
  w.rc_moving = take(C);
  w.rc_completed = take(C);
  w.rc_executing = take(C);
  w.rc_commit = take(C);
  w.rc_facts = take(C);
  w.rc_cnt = take(C * 3 * a.BL);
  w.t_job = takef(a.J);
  w.q_job = take(a.J);
  w.jcnt = take(a.J);
  w.itv_lv = take(a.BI);
  w.itv_rv = take(a.BI);
  w.itv_li = take(a.BI);
  w.itv_ri = take(a.BI);
  w.elected = reinterpret_cast<uint32_t*>(take(bitmap_words(a)));
  w.slot = take((long long)a.J * a.S);
  w.cand_slot = take(C);
  w.ov_rem = take(C);
  w.ov_comp = take(C);
  w.ov_mov = take(C);
  w.ov_exe = take(C);
  w.ov_dur = takef(C);
  w.ov_flags = reinterpret_cast<uint32_t*>(take(C));
  w.uni0 = takef(kRing * N);
  w.uni1 = takef(kRing * N);
  w.scal = take(kNumScal);
  return w;
}

// `sample_task_duration` (with `sample_executor_key`) for one draw at
// candidate c's stage, from its rows in shared memory and the uniforms
// (u0, u1): the trace's level for `num_local` executors, interpolating
// between the two levels that bracket it by u0 (the presence fallback
// where the level is absent), the wave from the task's validity and
// stage, a bucket sample picked by u1 (the one global load), the stage's
// rough duration where the bucket is empty, plus the warm-up delay of a
// fresh executor
template <class Dur>
ENGINE_HD float sample_duration(const BulkArgs& a, const LaneWork& w, int c,
                                float u0, float u1, int num_local,
                                bool task_valid, bool same_stage) {
  const int BL = a.BL;
  const int nl = clampi(num_local, 0, a.BI - 1);
  const int lv = w.itv_lv[nl], rv = w.itv_rv[nl];
  const int rand_pt = 1 + (int)fmul_rn(u0, (float)(rv - lv));
  const bool use_left = (lv == rv) || (rand_pt <= num_local - lv);
  const int key_idx = use_left ? w.itv_li[nl] : w.itv_ri[nl];
  const int key_val = use_left ? lv : rv;
  const bool present =
      (((uint32_t)w.rc_present[c] >> clampi(key_idx, 0, BL - 1)) & 1u) &&
      key_val > 0;
  const int li = clampi(present ? key_idx : w.rc_mp[c], 0, BL - 1);
  const int32_t* cnt = w.rc_cnt + (long long)c * 3 * BL;
  const int c_fresh = cnt[kWaveFresh * BL + li];
  const int c_first = cnt[kWaveFirst * BL + li];
  const int c_rest = cnt[kWaveRest * BL + li];
  const bool h_fresh = c_fresh > 0, h_first = c_first > 0, h_rest = c_rest > 0;
  const int wave =
      !task_valid ? (h_fresh ? kWaveFresh : kWaveFirst)
      : same_stage ? (h_rest ? kWaveRest : (h_first ? kWaveFirst : kWaveFresh))
                   : (h_first ? kWaveFirst : kWaveFresh);
  const bool warm = !task_valid && !h_fresh;
  const int cw = wave == kWaveFresh ? c_fresh
                 : wave == kWaveFirst ? c_first
                                      : c_rest;
  const int n = cw > 1 ? cw : 1;
  const int draw = (int)fmul_rn(u1, (float)n);
  const int pick = draw < n - 1 ? draw : n - 1;
  // the sample read where the bucket is empty too (its first entry), and
  // not taken: no branch
  float dur = Dur::at(
      a.bank_dur, (((long long)w.rc_ts[c] * 3 + wave) * BL + li) * a.BK + pick);
  if (Dur::kNarrow && a.bank_dur_scale != nullptr)
    dur = expm1_f32(fmul_rn(dur, w.rc_scale[c]));
  dur = cw > 0 ? dur : w.rc_rough[c];
  return fadd_rn(dur, warm ? a.warmup_delay : 0.0f);
}

// dst[0, nbytes) = src[0, nbytes) for n segments at once, the share of
// thread `tid` of `nthreads`: 16-byte words where both sides of a segment
// are aligned, two of each segment loaded before any is stored (2n loads
// in flight a thread), then the rest bytewise
template <int n>
ENGINE_WARP void copy_segments(void* const (&dst)[n],
                               const void* const (&src)[n],
                               const long long (&nbytes)[n], int tid,
                               int nthreads) {
  long long done[n];
  for (int f = 0; f < n; ++f) done[f] = 0;
#if defined(__CUDA_ARCH__)
  long long n16[n], most = 0;
#pragma unroll
  for (int f = 0; f < n; ++f) {
    const bool aligned = (((uintptr_t)dst[f] | (uintptr_t)src[f]) & 15) == 0;
    n16[f] = aligned ? nbytes[f] / 16 : 0;
    done[f] = n16[f] * 16;
    most = n16[f] > most ? n16[f] : most;
  }
  for (long long i = tid; i < most; i += 2LL * nthreads) {
    uint4 v[n][2];
#pragma unroll
    for (int f = 0; f < n; ++f)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (i + u * nthreads < n16[f])
          v[f][u] = static_cast<const uint4*>(src[f])[i + u * nthreads];
#pragma unroll
    for (int f = 0; f < n; ++f)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (i + u * nthreads < n16[f])
          static_cast<uint4*>(dst[f])[i + u * nthreads] = v[f][u];
  }
#endif
  for (int f = 0; f < n; ++f) {
    unsigned char* d = static_cast<unsigned char*>(dst[f]);
    const unsigned char* s = static_cast<const unsigned char*>(src[f]);
    for (long long i = done[f] + tid; i < nbytes[f]; i += nthreads) d[i] = s[i];
  }
}

// Candidate c's target stage d (job j, clamped) into the scratch: its
// input counts and facts, and its bank rows through the job's template.
// Each round of loads is issued before anything is stored.
ENGINE_HD void load_candidate(const BulkArgs& a, int b, const LaneWork& w,
                              int c, int j, int d) {
  const int S = a.S, BL = a.BL;
  const long long x = (long long)b * a.J * S + d;
  const int32_t rem = ld(a.stage_remaining + x);
  const int32_t moving = ld(a.moving_count + x);
  const int32_t completed = ld(a.stage_completed_tasks + x);
  const int32_t executing = ld(a.stage_executing + x);
  const int32_t commit = ld(a.commit_count + x);
  const uint8_t exists = ld(a.stage_exists + x), sat = ld(a.stage_sat + x);
  const int t = ld(a.job_template + (long long)b * a.J + j);
  const long long ts = (long long)t * a.BS + d % S;
  const int32_t mp = ld(a.bank_max_present + ts);
  const float rough = ld(a.bank_rough_duration + ts);
  const float scale =
      a.bank_dur_scale != nullptr ? ld(a.bank_dur_scale + t) : 0.0f;
  uint32_t present = 0u;
  for (int l = 0; l < BL; ++l)
    present |= ld(a.bank_level_present + ts * BL + l) ? (1u << l) : 0u;
  w.rc_stage[c] = d;
  w.rc_rem[c] = rem;
  w.rc_moving[c] = moving;
  w.rc_completed[c] = completed;
  w.rc_executing[c] = executing;
  w.rc_commit[c] = commit;
  w.rc_facts[c] = (exists ? kExists : 0) | (sat ? kSat : 0);
  w.rc_ts[c] = (int32_t)ts;
  w.rc_present[c] = (int32_t)present;
  w.rc_mp[c] = mp;
  w.rc_rough[c] = rough;
  w.rc_scale[c] = scale;
  int32_t* cnt = w.rc_cnt + (long long)c * 3 * BL;
  const int32_t* src = a.bank_cnt + ts * 3 * BL;
  int q = 0;
#if defined(__CUDA_ARCH__)
  if ((((uintptr_t)cnt | (uintptr_t)src) & 15) == 0)
#pragma unroll 8
    for (; q + 4 <= 3 * BL; q += 4)
      *reinterpret_cast<uint4*>(cnt + q) =
          ld(reinterpret_cast<const uint4*>(src + q));
#endif
  for (; q < 3 * BL; ++q) cnt[q] = ld(src + q);
}

// Thread `tid` of `nthreads`' share of lane b's setup: the scratch from
// the inputs (each executor's views and its two candidates, the jobs'
// arrival events, the interval tables, the cleared election bitmap and
// live counts). Each thread writes entries no other thread writes; then,
// each after a barrier of the setup's threads, `bulk_events_lane_elect`
// (and `bulk_events_lane_jobs`) and `bulk_events_lane_slots`.
ENGINE_HD void bulk_events_lane_init(const BulkArgs& a, int b,
                                     const LaneWork& w, int tid,
                                     int nthreads) {
  const int N = a.N, J = a.J, S = a.S;
  const long long bjs = (long long)b * J * S, bj = (long long)b * J;
  for (int i = tid; i < a.BI; i += nthreads) {
    w.itv_lv[i] = ld(a.bank_itv_left_val + i);
    w.itv_rv[i] = ld(a.bank_itv_right_val + i);
    w.itv_li[i] = ld(a.bank_itv_left_idx + i);
    w.itv_ri[i] = ld(a.bank_itv_right_idx + i);
  }
  for (int i = tid; i < bitmap_words(a); i += nthreads) w.elected[i] = 0u;
  for (int j = tid; j < J; j += nthreads) {
    const uint8_t arrived = ld(a.job_arrived + bj + j);
    const float t = ld(a.job_arrival_time + bj + j);
    const int32_t q = ld(a.job_arrival_seq + bj + j);
    w.t_job[j] = arrived ? inf_f32() : t;
    w.q_job[j] = q;
    w.jcnt[j] = 0;
  }
  const long long bn = (long long)b * N;
  for (int c = tid; c < 2 * N; c += nthreads) {
    const long long x = bn + c % N;
    const int dj = ld(a.exec_dst_job + x), ds0 = ld(a.exec_dst_stage + x);
    const int dc = clampi(dj, 0, J - 1);
    const int d = dc * S + clampi(ds0, 0, S - 1);
    if (c >= N) {  // executor c - N's arrival
      load_candidate(a, b, w, c, dc, d);
      continue;
    }
    const int e = c;
    const float t_f = ld(a.exec_finish_time + x);
    const int32_t sq_f = ld(a.exec_finish_seq + x);
    const float t_a = ld(a.exec_arrive_time + x);
    const int32_t sq_a = ld(a.exec_arrive_seq + x);
    const int32_t ej = ld(a.exec_job + x), es = ld(a.exec_stage + x);
    const int32_t ets = ld(a.exec_task_stage + x);
    const uint8_t valid = ld(a.exec_task_valid + x);
    const uint8_t moving = ld(a.exec_moving + x);
    const uint8_t at_common = ld(a.exec_at_common + x);
    const uint8_t executing = ld(a.exec_executing + x);
    const uint8_t src_valid = ld(a.source_valid + b);
    const int32_t src_job = ld(a.source_job + b);
    const int32_t src_stage = ld(a.source_stage + b);
    // the arrival's static facts on the input state: it starts a task
    // where its (clamped) destination is on the frontier
    const uint8_t d_exists = ld(a.stage_exists + bjs + d);
    const int32_t d_completed = ld(a.stage_completed_tasks + bjs + d);
    const int32_t d_tasks = ld(a.stage_num_tasks + bjs + d);
    const int32_t d_parents = ld(a.incomplete_parent_count + bjs + d);
    const int fj = clampi(ej, 0, J - 1), fs = clampi(ets, 0, S - 1);
    load_candidate(a, b, w, e, fj, fj * S + fs);
    const bool start = d_exists && !(d_completed >= d_tasks) &&
                       d_parents == 0;
    const bool joins = src_valid && dj == src_job &&
                       (start ? ds0 == src_stage : src_stage == -1);
    const bool in = dj >= 0 && dj < J && ds0 >= 0 && ds0 < S;
    w.t_f[e] = t_f;
    w.sq_f[e] = sq_f;
    w.t_a[e] = t_a;
    w.sq_a[e] = sq_a;
    w.frow[e] = e;
    w.ej[e] = ej;
    w.ex_stage[e] = es;
    w.ex_ts[e] = ets;
    w.ex_dj[e] = dj;
    w.ex_ds[e] = ds0;
    w.flags[e] = (start ? kStartA : 0) | (joins ? kJoinsA : 0) |
                 (valid ? kValidA : 0) | (ets == ds0 ? kSameA : 0) |
                 (in ? kDstIn : 0) | (moving ? kMoving : 0) |
                 (at_common ? kAtCommon : 0) | (executing ? kExecuting : 0);
  }
}

// Thread `tid`'s share of the election of each distinct candidate stage's
// slot: the first candidate to set the stage's bit (any order: a slot
// only has to be one per stage).
ENGINE_WARP void bulk_events_lane_elect(const BulkArgs& a, const LaneWork& w,
                                        int tid, int nthreads) {
  for (int c = tid; c < 2 * a.N; c += nthreads) {
    const int d = w.rc_stage[c];
    const uint32_t bit = 1u << (d & 31);
    if (!(atomic_or(&w.elected[d >> 5], bit) & bit)) w.slot[d] = c;
  }
}

// Thread `tid`'s share of the slots: each candidate's, and each slot's
// overlay from its stage's inputs.
ENGINE_HD void bulk_events_lane_slots(const BulkArgs& a, const LaneWork& w,
                                      int tid, int nthreads) {
  for (int c = tid; c < 2 * a.N; c += nthreads) {
    const int k = w.slot[w.rc_stage[c]];
    w.cand_slot[c] = k;
    w.ov_rem[c] = w.rc_rem[c];
    w.ov_comp[c] = 0;
    w.ov_mov[c] = 0;
    w.ov_exe[c] = 0;
    w.ov_flags[c] = 0u;
  }
}

// One warp's part of lane b's setup, after `bulk_events_lane_init`
// (beside `bulk_events_lane_elect`): the live executors per job and the
// job arrivals' (time, seq) minimum (the only competitor kind, never
// consumed here), from shared memory.
ENGINE_WARP void bulk_events_lane_jobs(const BulkArgs& a, const LaneWork& w) {
  const int N = a.N, J = a.J;
  each_lane([&](int l) {
    for (int e = l; e < N; e += kWarp) {
      const int j = w.ej[e];
      if (j >= 0 && j < J) atomic_add(&w.jcnt[j], 1);
    }
  });
  Lanes<EventArg> jm;
  Lanes<bool> jnan;
  each_lane([&](int l) {
    bool nan = false;
    jm[l] = lane_event_arg(w.t_job, w.q_job, J, l, nan);
    jnan[l] = nan;
  });
  const bool jt_nan = any_lane(jnan);
  butterfly(jm);
  float jt;
  int jseq, unused;
  event_result(jm.uniform(), jt, jseq, unused);
  one_lane([&] {
    w.scal[kJobT] = float_bits(jt);
    w.scal[kJobSeq] = jseq;
    w.scal[kJobNan] = jt_nan;
  });
}

// One warp's part of lane b's setup, beside `bulk_events_lane_init`: the
// lane's scalars (lane 0) and keys, a 2-word half a lane: the uniforms'
// key (lanes 1, 2) and the next key that the lane takes where it bulks
// (lanes 3, 4).
ENGINE_WARP void bulk_events_lane_keys(const BulkArgs& a, int b,
                                       const LaneWork& w) {
  const int64_t* key = a.rng + (long long)b * a.KS;
  // the uniforms' key: under threefry the lane's second key, under rbg
  // the second key of lane 0's (each 2-word half at counter 1)
  const int64_t* sub_of = a.W == 4 ? a.rng : key;
  each_lane([&](int l) {
    int32_t* s = w.scal;
    if (l == 0) {
      s[kEnabled] = ld(a.enabled + b);
      s[kLimit] = float_bits(ld(a.time_limit + b));
      s[kCounter] = ld(a.seq_counter + b);
      s[kWall] = float_bits(ld(a.wall_time + b));
      s[kReady] = 0;
      s[kTaken] = 0;
      s[kStop] = 0;
      if (a.W == 2) s[kSub + 2] = s[kSub + 3] = 0;  // no second half
    }
    if (l >= 1 && l <= a.W / 2) {  // a half of the uniforms' key
      const int h = 2 * (l - 1);
      uint32_t x, y;
      prng_core::threefry_at((uint32_t)sub_of[h], (uint32_t)sub_of[h + 1],
                             1, x, y);
      s[kSub + h] = (int32_t)x;
      s[kSub + h + 1] = (int32_t)y;
    }
    if (l >= 3 && l < 3 + a.W / 2) {  // a half of the next key
      const int h = 2 * (l - 3);
      int64_t next[2];
      prng_core::split_next_key(key + h, 2, next);
      s[kNext + h] = (int32_t)next[0];
      s[kNext + h + 1] = (int32_t)next[1];
    }
  });
}

// Thread `tid` of `nthreads`' share of the copy of lane b's written
// [J, S] and [J] fields from input to output: the pass changes a few
// entries of each, which `bulk_events_lane_finish` writes over the copy.
// Reads no scratch; runs beside the setup and the scan.
ENGINE_WARP void bulk_events_copy(const BulkArgs& a, int b, int tid,
                                  int nthreads) {
  const long long js = (long long)a.J * a.S, bjs = b * js;
  const long long bj = (long long)b * a.J;
  void* const dst[8] = {a.out_stage_remaining + bjs,
                        a.out_stage_executing + bjs,
                        a.out_stage_completed_tasks + bjs,
                        a.out_stage_duration + bjs,
                        a.out_unsat_parent_count + bjs,
                        a.out_moving_count + bjs,
                        a.out_stage_sat + bjs,
                        a.out_job_saturated_stages + bj};
  const void* const src[8] = {a.stage_remaining + bjs,
                              a.stage_executing + bjs,
                              a.stage_completed_tasks + bjs,
                              a.stage_duration + bjs,
                              a.unsat_parent_count + bjs,
                              a.moving_count + bjs,
                              a.stage_sat + bjs,
                              a.job_saturated_stages + bj};
  const long long nbytes[8] = {4 * js, 4 * js, 4 * js, 4 * js,
                               4 * js, 4 * js, js,     4LL * a.J};
  copy_segments<8>(dst, src, nbytes, tid, nthreads);
}

// The uniforms of step i (the pairs of every executor) into ring row
// i % kRing: thread `tid` of `nthreads`' share
ENGINE_HD void produce_row(const BulkArgs& a, const LaneWork& w,
                           const StepDraw& draw, int i, int tid,
                           int nthreads) {
  const int N = a.N;
  float* u0 = w.uni0 + (i % kRing) * N;
  float* u1 = w.uni1 + (i % kRing) * N;
  for (int e = tid; e < N; e += nthreads)
    draw.pair(((uint64_t)i * N + e) * 2, u0[e], u1[e]);
}

ENGINE_HD StepDraw step_draw(const BulkArgs& a, int b, const LaneWork& w) {
  StepDraw draw;
  draw.rbg = a.W == 4;
  for (int h = 0; h < 4; ++h) draw.sub[h] = (uint32_t)w.scal[kSub + h];
  draw.lane_words = (uint64_t)b * a.L * a.N * 2;
  return draw;
}

#if defined(__CUDACC__)
// kProducers threads (warps 1-3) make the uniforms' rows for steps 0, 1,
// ... while the scan runs, at most kRing rows ahead of it, until it stops
// or every row is made; producer `tid` of them. One thread waits for room
// and publishes each row after the producers' barrier.
ENGINE_WARP void bulk_events_produce(const BulkArgs& a, int b,
                                     const LaneWork& w, int tid) {
  const StepDraw draw = step_draw(a, b, w);
  int32_t* s = w.scal;
  for (int i = 0; i < a.L; ++i) {
    if (tid == 0) {
      int go = 1;
      while (true) {
        if (vload(s + kStop)) {
          go = 0;
          break;
        }
        if (i - vload(s + kTaken) < kRing) break;
      }
      s[kGo] = go;
    }
    asm volatile("bar.sync 2, %0;" ::"n"(kProducers) : "memory");
    if (!s[kGo]) break;
    produce_row(a, w, draw, i, tid, kProducers);
    fence_block();
    asm volatile("bar.sync 2, %0;" ::"n"(kProducers) : "memory");
    if (tid == 0) vstore(s + kReady, i + 1);
  }
}
#endif

// Step i's uniforms in the ring: on the card, wait for the producers; in
// the host build, make the row here
ENGINE_WARP void await_row(const BulkArgs& a, int b, const LaneWork& w,
                           int i) {
#if defined(__CUDACC__)
  while (vload(w.scal + kReady) <= i) {
  }
  fence_block();
#else
  produce_row(a, w, step_draw(a, b, w), i, 0, 1);
#endif
}

// What lane l knows of its least event of a kind (`at`, kNoIndex where
// the lane has none) at step i: the candidate's stage, live remaining
// count, slot and row, and the duration a launch of it would draw with
// the step's uniforms of that executor (no branch: it runs beside the
// butterfly)
template <class Dur>
ENGINE_HD Cand lane_cand(const BulkArgs& a, const LaneWork& w, int i,
                         bool fin, int at) {
  const int N = a.N;
  const int e = at < N ? at : 0;  // none: any executor, never chosen
  Cand c;
  c.row = fin ? w.frow[e] : N + e;
  c.stage = w.rc_stage[c.row];
  c.slot = w.cand_slot[c.row];
  c.rem = w.ov_rem[c.slot];
  const int32_t fl = w.flags[e];
  const int nl = w.jcnt[c.stage / a.S] + (fin ? 0 : 1);
  const int u = (i % kRing) * N + e;
  c.dur = sample_duration<Dur>(a, w, c.row, w.uni0[u], w.uni1[u], nl,
                               fin || (fl & kValidA), fin || (fl & kSameA));
  return c;
}

// Lane b's scan, on one warp after the setup (see the file comment and
// `core._bulk_events_fused_ref`), and the overlay slots of the consumed
// arrivals' destinations; its per-lane results go to w.scal for
// `bulk_events_lane_finish`. Reads the scratch only.
template <class Dur>
ENGINE_WARP void bulk_events_scan(const BulkArgs& a, int b,
                                  const LaneWork& w) {
  const int N = a.N, S = a.S;
  const int32_t* s = w.scal;
  const float jt = bits_float(s[kJobT]);
  const int jseq = s[kJobSeq];
  const float limit = bits_float(s[kLimit]);
  int counter = s[kCounter];
  float wall = bits_float(s[kWall]);
  int k_rel = 0, k_rdy = 0;
  bool crossed = false;
  const bool active = s[kEnabled] && !s[kJobNan];

  for (int i = 0; active && i < a.L; ++i) {
    await_row(a, b, w, i);
    Lanes<StepMin> m;
    Lanes<bool> nan;
    Lanes<Cand> cf, ca;
    each_lane([&](int l) {
      bool bad = false;
      m[l].f = lane_event_arg(w.t_f, w.sq_f, N, l, bad);
      m[l].a = lane_event_arg(w.t_a, w.sq_a, N, l, bad);
      nan[l] = bad;
      cf[l] = lane_cand<Dur>(a, w, i, true, m[l].f.at);
      ca[l] = lane_cand<Dur>(a, w, i, false, m[l].a.at);
    });
    const bool nan_any = any_lane(nan);
    butterfly(m);  // on NaN too: no branch before the candidates are in
    if (nan_any) break;  // a NaN time: no event is finite
    float ftmin, atmin;
    int fsmin, asmin, fe, ae;
    event_result(m.uniform().f, ftmin, fsmin, fe);
    event_result(m.uniform().a, atmin, asmin, ae);
    const bool is_fin =
        (ftmin < atmin) || ((ftmin == atmin) && (fsmin < asmin));
    const float tmin = is_fin ? ftmin : atmin;
    if (!(tmin < inf_f32() && tmin > -inf_f32())) break;  // no event
    const int smin = is_fin ? fsmin : asmin;
    const bool before_job = (tmin < jt) || ((tmin == jt) && (smin < jseq));
    const int e = is_fin ? fe : ae;
    if (e < 0) break;  // no event at the least time has a seq below BIG_SEQ
    // the winner is its owner lane's least event of its kind
    Lanes<Cand> kind;
    each_lane([&](int l) { kind[l] = is_fin ? cf[l] : ca[l]; });
    const Cand c = from_lane(kind, e % kWarp);
    bool ok = before_job && c.rem > 0;
    if (a.stop_at_limit) {
      ok = ok && !crossed;
      crossed = crossed || (ok && tmin >= limit);
    }
    if (!ok) break;

    const int tj = c.stage / S;
    const int32_t fl = w.flags[e];
    const bool start_a = !is_fin && (fl & kStartA);
    const int k = c.slot;
    const bool launch = is_fin || start_a;
    one_lane([&] {  // the step's writes, in one place
      vstore(w.scal + kTaken, i + 1);
      if (launch) {
        w.t_f[e] = fadd_rn(tmin, c.dur);
        w.sq_f[e] = counter;
        w.ov_rem[k] = c.rem - 1;
        w.ov_dur[k] = c.dur;
        w.ov_flags[k] |= kTouched | kLaunched;
      }
      if (is_fin) {
        w.ov_comp[k] += 1;
      } else {
        w.t_a[e] = inf_f32();
        w.flags[e] |= kArrived | (start_a ? kStarted : 0);
        w.jcnt[tj] += 1;
        if (start_a) w.frow[e] = c.row;
      }
    });
    counter += launch ? 1 : 0;
    k_rel += is_fin ? 1 : 0;
    k_rdy += is_fin ? 0 : 1;
    wall = tmin;
    sync_lanes();  // the step's writes before the next step's reads
    if (!is_fin && (fl & kJoinsA)) break;  // consumed, then the run ends
  }

  one_lane([&] {
    vstore(w.scal + kStop, 1);  // the producers stop
    w.scal[kOutWall] = float_bits(wall);
    w.scal[kOutCounter] = counter;
    w.scal[kKRel] = k_rel;
    w.scal[kKRdy] = k_rdy;
  });
  // the consumed arrivals' counts on their (static, unclamped)
  // destinations' slots
  each_lane([&](int l) {
    for (int e = l; e < N; e += kWarp) {
      if ((w.flags[e] & (kArrived | kDstIn)) != (kArrived | kDstIn)) continue;
      const int k = w.cand_slot[N + e];
      atomic_add(&w.ov_mov[k], -1);
      if (w.flags[e] & kStarted) atomic_add(&w.ov_exe[k], 1);
      atomic_or(&w.ov_flags[k], kTouched);
    }
  });
}

// Thread `tid` of `nthreads`' share of lane b's outputs, after the scan
// and the copy (the caller syncs between them): each touched stage once,
// its overlay over the copy with the saturation-cache refresh (the job's
// fully launched stages and the children's unsaturated-parent counts,
// integer atomics over its `adj` row), then the executors and the lane.
// Reads the scratch only.
ENGINE_WARP void bulk_events_lane_finish(const BulkArgs& a, int b,
                                         const LaneWork& w, int tid,
                                         int nthreads) {
  const int J = a.J, S = a.S;
  const long long bjs = (long long)b * J * S;
  const int32_t* s = w.scal;
  for (int c = tid; c < 2 * a.N; c += nthreads) {
    const uint32_t f = w.ov_flags[c];
    if (!(f & kTouched)) continue;
    const int d = w.rc_stage[c], j = d / S;
    const long long x = bjs + d;
    const int rem = w.ov_rem[c];
    const int moving = w.rc_moving[c] + w.ov_mov[c];
    a.out_stage_remaining[x] = rem;
    a.out_stage_completed_tasks[x] = w.rc_completed[c] + w.ov_comp[c];
    a.out_stage_executing[x] = w.rc_executing[c] + w.ov_exe[c];
    a.out_moving_count[x] = moving;
    if (f & kLaunched) {
      a.out_stage_duration[x] = w.ov_dur[c];
      if (rem == 0) atomic_add(&a.out_job_saturated_stages[(long long)b * J + j], 1);
    }
    const bool sat_new = rem - moving - w.rc_commit[c] <= 0;
    if (w.rc_facts[c] & kExists) {
      const int delta = (int)sat_new - (int)((w.rc_facts[c] & kSat) != 0);
      if (delta != 0) {
        const uint8_t* adj_row = a.adj + x * S;
        int32_t* unsat = a.out_unsat_parent_count + bjs + (long long)j * S;
        for (int ch = 0; ch < S; ++ch)
          if (adj_row[ch]) atomic_add(&unsat[ch], -delta);
      }
    }
    a.out_stage_sat[x] = sat_new ? 1 : 0;
  }
  const long long bn = (long long)b * a.N;
  for (int e = tid; e < a.N; e += nthreads) {
    const long long x = bn + e;
    const int32_t fl = w.flags[e];
    const bool arrived = fl & kArrived;
    const bool started = fl & kStarted;
    a.out_exec_finish_time[x] = w.t_f[e];
    a.out_exec_finish_seq[x] = w.sq_f[e];
    a.out_exec_arrive_time[x] = w.t_a[e];
    a.out_exec_moving[x] = (fl & kMoving) && !arrived;
    a.out_exec_at_common[x] = (fl & kAtCommon) && !arrived;
    a.out_exec_job[x] = arrived ? w.ex_dj[e] : w.ej[e];
    a.out_exec_stage[x] = arrived ? (started ? w.ex_ds[e] : -1)
                                  : w.ex_stage[e];
    a.out_exec_task_valid[x] = arrived ? started : (fl & kValidA) != 0;
    a.out_exec_executing[x] = (fl & kExecuting) || started;
    a.out_exec_task_stage[x] = started ? w.ex_ds[e] : w.ex_ts[e];
  }
  // the next key where the lane bulked, else its own key
  const bool bulked = s[kKRel] + s[kKRdy] > 0;
  const int64_t* key = a.rng + (long long)b * a.KS;
  int64_t* next = a.out_rng + (long long)b * a.W;
  for (int h = tid; h < a.W; h += nthreads)
    next[h] = bulked ? (int64_t)(uint32_t)s[kNext + h] : key[h];
  if (tid == 0) {
    a.out_wall_time[b] = bits_float(s[kOutWall]);
    a.out_seq_counter[b] = s[kOutCounter];
    a.out_k_rel[b] = s[kKRel];
    a.out_k_rdy[b] = s[kKRdy];
  }
}

}  // namespace engine_core

// The fused bulk event pass as one kernel: `core._bulk_events_fused` over
// every lane in one launch, with its split-then-draw folded in.
//
// Replaces: `_bulk_events_fused`, sparksched_tpu/env/core.py:1478-1740 (an
// XLA-compiled function, no Pallas kernel): its `jax.random.split` and
// vmapped `jax.random.uniform` (:1570-1574), the `lax.scan` over
// `max_events + N` steps (:1672) with `sample_task_duration` /
// `sample_executor_key` (sparksched_tpu/workload/sampling.py:74, :45) a
// step, and the merged state write. In the port it replaces the plain
// version `core._bulk_events_fused_ref`: a `split_uniform` launch for a
// [B, L, N, 2] uniform table, then a host loop of up to L = max_events + N
// masked steps (~85 torch ops and one host sync each) and ~65 ops around
// it.
//
// What bounds it: the pass is a sequential scan per lane (each step's
// winner depends on the last step's writes), so the work is L steps of an
// argmin over 2N events, a few dependent gathers from the bank and one or
// two hashes; the bytes are the lane's state read and the changed fields
// written once. Both are microseconds at the main path's 16 lanes x
// [200, 20] stages x 50 executors: the launch and the scan's latency
// decide.
//
// The design: one block of 256 threads per lane, its warps in roles.
// Warps 4-7 copy the lane's inputs of every written [J, S] and [J] field
// to the outputs from the start (16-byte words, 16 loads in flight a
// thread). Warps 0-3 load into shared memory what the scan reads: the
// executors' event views and arrival facts and, for each of the 2N stages
// the pass can launch at or arrive at (each executor's finish target and
// its arrival's destination), the stage's input counts, facts and `adj`
// row and its bank rows (counts, presence, fallback level, rough
// duration); warp 3 also takes the live executors per job, the job
// arrivals' minimum and the keys. After a barrier of those four warps,
// warp 0 runs the scan (engine_core.cuh) while the copy may still run:
// the scan reads the inputs through a shared-memory overlay of the stages
// it touched, never the outputs. A step's event minimum is a warp
// reduction (lane l over executors l, l + 32, ..., five xor-shuffle
// rounds), each lane meanwhile deriving the uniforms and target of its own
// least events, so the winner's come by one shuffle from its lane; the
// duration model then reads shared memory but for the bucket sample, one
// global load a launch. After a barrier of all threads every thread writes
// the overlay over the copy (each touched stage once; the job's fully
// launched stages and the children's unsaturated-parent counts by integer
// atomics over its `adj` row), the executors' outputs and the lane's.
// The uniforms are derived where consumed, one pair per step, so the
// [B, L, N, 2] table is never written; under rbg each lane derives lane
// 0's second key itself (the vmapped draw is ONE stream of it).
// No host sync and no second launch.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#include "engine_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSetupThreads = 128;  // warps 0-3 set up; warps 4-7 copy
constexpr int kLoadThreads = 96;    // warps 0-2 elect; warp 3 the jobs
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory

// barriers of some warps only: the loads' end (warps 0-3 and warp 4, which
// takes the keys), then the setup's rounds (warps 0-3); the copy runs on
__device__ __forceinline__ void loads_barrier() {
  asm volatile("bar.sync 3, %0;" ::"n"(kSetupThreads + engine_core::kWarp)
               : "memory");
}

__device__ __forceinline__ void setup_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kSetupThreads) : "memory");
}

template <class Dur>
__global__ void __launch_bounds__(kThreads, 1)
    bulk_events_fused_kernel(engine_core::BulkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const engine_core::LaneWork w = engine_core::carve_lane_work(smem, a);
  const int b = blockIdx.x;
  if (threadIdx.x < kSetupThreads) {
    engine_core::bulk_events_lane_init(a, b, w, threadIdx.x, kSetupThreads);
    loads_barrier();
    if (threadIdx.x < kLoadThreads) {
      engine_core::bulk_events_lane_elect(a, w, threadIdx.x, kLoadThreads);
    } else {
      engine_core::bulk_events_lane_jobs(a, w);
    }
    setup_barrier();
    engine_core::bulk_events_lane_slots(a, w, threadIdx.x, kSetupThreads);
    setup_barrier();
    if (threadIdx.x < engine_core::kWarp) {
      engine_core::bulk_events_scan<Dur>(a, b, w);
    } else {
      engine_core::bulk_events_produce(a, b, w,
                                       threadIdx.x - engine_core::kWarp);
    }
  } else {
    if (threadIdx.x < kSetupThreads + engine_core::kWarp) {
      engine_core::bulk_events_lane_keys(a, b, w);
      loads_barrier();
    }
    engine_core::bulk_events_copy(a, b, threadIdx.x - kSetupThreads,
                                  blockDim.x - kSetupThreads);
  }
  __syncthreads();
  engine_core::bulk_events_lane_finish(a, b, w, threadIdx.x, blockDim.x);
}

template <class Dur>
int launch(const engine_core::BulkArgs& a, cudaStream_t s) {
  const long long smem = engine_core::lane_work_bytes(a);
  if (smem > kMaxSmem) return -2;
  if (smem > 48 * 1024) {
    // raise the instantiation's cap to the whole block's share, once
    static std::once_flag once;
    static cudaError_t cap_rc = cudaSuccess;
    std::call_once(once, [] {
      cap_rc = cudaFuncSetAttribute(bulk_events_fused_kernel<Dur>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kMaxSmem);
    });
    if (cap_rc != cudaSuccess) return (int)cap_rc;
  }
  bulk_events_fused_kernel<Dur><<<a.B, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bulk_events_arg_counts(int* pointers, int* dims) {
  *pointers = engine_core::kNumPointers;
  *dims = engine_core::kNumDims;
  return 0;
}

// ptrs: engine_core::kNumPointers device addresses in BULK_EVENTS_POINTERS
// order; dims: engine_core::kNumDims sizes in BULK_EVENTS_DIMS order.
// Launches one block per lane on `stream`; returns cudaGetLastError() (0 on
// success), -1 on bad sizes, -2 when a lane's scratch exceeds shared memory.
extern "C" int bulk_events_fused_launch(const int64_t* ptrs,
                                        const int64_t* dims,
                                        float warmup_delay, void* stream) {
  const engine_core::BulkArgs a =
      engine_core::bulk_args_from(ptrs, dims, warmup_delay);
  if (!engine_core::bulk_args_valid(a)) return -1;
  if (a.B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.dur_kind) {
    case 0: return launch<engine_core::DurF32>(a, s);
    case 1: return launch<engine_core::DurBf16>(a, s);
    case 2: return launch<engine_core::DurInt<int16_t>>(a, s);
    case 3: return launch<engine_core::DurInt<int8_t>>(a, s);
    default: return -1;
  }
}

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
// The design: one block per lane. Its threads copy the lane's inputs of
// every written field to the outputs (strided, 16-byte words) and load
// into shared memory what the scan reads: the executors' event views and
// static arrival facts, the jobs' arrival events and templates. Then one
// thread runs the scan and a sparse epilogue (engine_core.cuh: only the
// stages a launch or an arrival touched, each once through a bitmap, and
// only their `adj` rows), its only global traffic the bank's gathers and
// the touched stages; then every thread writes the executors' outputs.
// The uniforms are derived where consumed, one pair per step, so the
// [B, L, N, 2] table is never written; under rbg each lane derives lane
// 0's second key itself (the vmapped draw is ONE stream of it).
// No host sync and no second launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "engine_core.cuh"

namespace {

constexpr int kThreads = 256;

template <class Dur>
__global__ void __launch_bounds__(kThreads)
    bulk_events_fused_kernel(engine_core::BulkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const engine_core::LaneWork w = engine_core::carve_lane_work(smem, a);
  engine_core::bulk_events_lane_init(a, blockIdx.x, w, threadIdx.x,
                                     blockDim.x);
  __syncthreads();
  if (threadIdx.x == 0)
    engine_core::bulk_events_fused_lane<Dur>(a, blockIdx.x, w);
  __syncthreads();
  engine_core::bulk_events_lane_finish(a, blockIdx.x, w, threadIdx.x,
                                       blockDim.x);
}

template <class Dur>
int launch(const engine_core::BulkArgs& a, cudaStream_t s) {
  const long long smem = engine_core::lane_work_bytes(a);
  if (smem > 227 * 1024) return -2;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        bulk_events_fused_kernel<Dur>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
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
  if (a.B < 0 || a.N < 1 || a.J < 1 || a.S < 1 || (a.W != 2 && a.W != 4) ||
      a.L < 0 || a.BI < 1 || a.BL < 1 || a.BK < 1)
    return -1;
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

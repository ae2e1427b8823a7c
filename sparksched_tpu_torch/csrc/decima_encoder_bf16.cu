// Decima NodeEncoder under compute_dtype="bfloat16": the forward, one job
// per block of 128 threads (grid = B*K).
//
// Replaces: sparksched_tpu/schedulers/decima.py `DecimaNet.__call__`, the
// NodeEncoder part, under compute_dtype="bfloat16" (:206-223 Dense(dtype=
// bf16) with the float32 params cast at use, :244-274 the level scan with
// the aggregation einsum in bf16, :285-288 the edgeless fallback and the
// node mask). XLA-compiled in the JAX package; no Pallas kernel.
//
// The arithmetic is encoder_bf16.cuh's (the rounding points are listed
// there): bf16 weights and values in shared memory, f32 sums inside each
// dot product. A simple kernel: each layer's outputs are spread over the
// block's threads, one output a thread, its inputs summed in order; every
// row of a layer is computed (no tensor cores, no per-row scheduling).
// A dead job (node_mask all false) writes zeros and leaves.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py); bound with ctypes through the
// C entry point at the bottom.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_bf16.cuh"

#define JOB_THREADS 128
#define SMEM_MAX (227 * 1024)

__global__ void __launch_bounds__(JOB_THREADS)
decima_node_encoder_bf16_kernel(const uint16_t* __restrict__ x,
                                const uint8_t* __restrict__ adj,
                                const int32_t* __restrict__ level,
                                const uint8_t* __restrict__ node_mask,
                                const uint8_t* __restrict__ edgeless,
                                const uint16_t* __restrict__ weights,
                                uint16_t* __restrict__ out, EncDims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  EncSm s;
  enc_carve(d, false, smem, &s);
  const Blk b{(int)threadIdx.x, (int)blockDim.x};
  enc_load_weights(b, d, weights, s);
  enc_forward_job(b, d, s, (long)blockIdx.x, x, adj, level, node_mask,
                  edgeless, out);
}

// C entry point: the arguments of decima_node_encoder_launch
// (decima_encoder.cu) with x, the packed weights and out as bf16, and the
// slope rounded to bf16. Returns cudaGetLastError() of the launch (0 on
// success), or -1 for dims the kernel does not take.
extern "C" int decima_node_encoder_bf16_launch(
    const uint16_t* x, const uint8_t* adj, const int32_t* level,
    const uint8_t* node_mask, const uint8_t* edgeless,
    const uint16_t* weights, uint16_t* out, int B, int K, int S, int F,
    int D, int nl, float slope, const int* mlp_spec, void* stream) {
  EncDims d;
  if (enc_dims(&d, mlp_spec, B, K, S, F, D, nl, slope) != 0) return -1;
  const long jobs = (long)B * K;
  if (jobs > 0x7fffffff) return -1;
  const size_t smem = enc_carve(d, false, nullptr, nullptr);
  if (smem > SMEM_MAX) return -1;
  static size_t opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        decima_node_encoder_bf16_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  if (jobs == 0) return 0;
  decima_node_encoder_bf16_kernel<<<(unsigned)jobs, JOB_THREADS, smem,
                                    (cudaStream_t)stream>>>(
      x, adj, level, node_mask, edgeless, weights, out, d);
  return (int)cudaGetLastError();
}

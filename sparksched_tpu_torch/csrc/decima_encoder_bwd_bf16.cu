// Decima NodeEncoder under compute_dtype="bfloat16": the gradient of
// decima_encoder_bf16.cu's function with respect to the three MLPs'
// weights and biases, given dL/dh (bf16), as float32 in the packed layout.
//
// Replaces: the gradient XLA derives for the bf16 NodeEncoder lines of
// sparksched_tpu/schedulers/decima.py (:206-223, :244-274, :285-288) under
// `jax.checkpoint` in `evaluate_actions` (:706-728): the PPO and VPG
// updates' backward through the GNN. No Pallas kernel in the JAX package.
//
// Design: a persistent grid of blocks of 128 threads, as many as the card
// holds at once (at most one per job); block g takes jobs g, g + G, ... in
// order and skips a dead job (node_mask all false: its gradient is 0).
// For a job it recomputes the bf16 forward of encoder_bf16.cuh, keeping h
// before each executed level, so every LeakyReLU mask comes from the very
// bf16 pre-activation the forward kernel saw; then walks the levels in
// reverse, recomputing each level's msg and update MLPs and taking their
// backward, and last the leaves' update and prep. Each weight's gradient
// is summed in f32 in the block's shared accumulator (jobs in order, rows
// in order); the blocks' accumulators go to global scratch and
// reduce_blocks_kernel adds them in block order: the result does not
// depend on timing, run to run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py); bound with ctypes through the
// C entry points at the bottom.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_bf16.cuh"

#define JOB_THREADS 128
#define SMEM_MAX (227 * 1024)

__global__ void __launch_bounds__(JOB_THREADS)
decima_node_encoder_bwd_bf16_kernel(const uint16_t* __restrict__ x,
                                    const uint8_t* __restrict__ adj,
                                    const int32_t* __restrict__ level,
                                    const uint8_t* __restrict__ node_mask,
                                    const uint8_t* __restrict__ edgeless,
                                    const uint16_t* __restrict__ weights,
                                    const uint16_t* __restrict__ grad_h,
                                    float* __restrict__ partial, long jobs,
                                    EncDims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  EncSm s;
  enc_carve(d, true, smem, &s);
  const Blk b{(int)threadIdx.x, (int)blockDim.x};
  enc_load_weights(b, d, weights, s);
  for (int i = b.t; i < d.wtotal; i += b.nt) s.acc[i] = 0.f;
  for (long job = blockIdx.x; job < jobs; job += gridDim.x)
    enc_backward_job(b, d, s, job, x, adj, level, node_mask, edgeless,
                     grad_h);
  __syncthreads();
  float* o = partial + (size_t)blockIdx.x * d.wtotal;
  for (int i = b.t; i < d.wtotal; i += b.nt) o[i] = s.acc[i];
}

// grad[i] = sum over blocks g, in order, of partial[g][i]
__global__ void reduce_blocks_kernel(const float* __restrict__ partial,
                                     int blocks, int wtotal,
                                     float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wtotal) return;
  float s = 0.f;
  for (int g = 0; g < blocks; ++g) s += partial[(size_t)g * wtotal + i];
  grad[i] = s;
}

static int setup(EncDims* d, const int* spec, int B, int K, int S, int F,
                 int D, int nl, float slope, int sms, size_t* smem,
                 int* blocks) {
  if (enc_dims(d, spec, B, K, S, F, D, nl, slope) != 0) return -1;
  *smem = enc_carve(*d, true, nullptr, nullptr);
  if (*smem > SMEM_MAX) return -1;
  static size_t opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (*smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        decima_node_encoder_bwd_bf16_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = *smem;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decima_node_encoder_bwd_bf16_kernel, JOB_THREADS, *smem);
  if (e != cudaSuccess) return (int)e;
  const long jobs = (long)B * K;
  long g = (long)(per_sm > 0 ? per_sm : 1) * sms;
  *blocks = (int)(jobs < g ? jobs : g);
  return 0;
}

// The scratch the launch needs, in bytes (the blocks' accumulators), for
// these dims on a card of `sms` SMs; 0, or -1 for dims the kernel does not
// take. The arguments of decima_node_encoder_bwd_scratch
// (decima_encoder_bwd.cu).
extern "C" int decima_node_encoder_bwd_bf16_scratch(int B, int K, int S,
                                                    int F, int D,
                                                    const int* mlp_spec,
                                                    int sms,
                                                    long long* nbytes) {
  EncDims d;
  size_t smem;
  int blocks;
  const int rc = setup(&d, mlp_spec, B, K, S, F, D, S, 0.f, sms, &smem,
                       &blocks);
  if (rc != 0) return rc;
  *nbytes = (long long)blocks * d.wtotal * sizeof(float);
  return 0;
}

// C entry point: the arguments of decima_node_encoder_bwd_launch
// (decima_encoder_bwd.cu) with x, the packed weights and grad_h as bf16
// and the slope rounded to bf16; grad (f32, the packed layout) is
// written whole. Returns cudaGetLastError() after the launches (0 on
// success), or -1 for dims the kernel does not take or too little
// scratch.
extern "C" int decima_node_encoder_bwd_bf16_launch(
    const uint16_t* x, const uint8_t* adj, const int32_t* level,
    const uint8_t* node_mask, const uint8_t* edgeless,
    const uint16_t* weights, const uint16_t* grad_h, void* scratch,
    long long scratch_bytes, float* grad, int B, int K, int S, int F, int D,
    int nl, float slope, const int* mlp_spec, int sms, void* stream) {
  EncDims d;
  size_t smem;
  int blocks;
  const int rc = setup(&d, mlp_spec, B, K, S, F, D, nl, slope, sms, &smem,
                       &blocks);
  if (rc != 0) return rc;
  if ((long long)blocks * d.wtotal * (long long)sizeof(float) >
      scratch_bytes)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks == 0) {
    cudaMemsetAsync(grad, 0, sizeof(float) * d.wtotal, st);
    return (int)cudaGetLastError();
  }
  float* partial = (float*)scratch;
  decima_node_encoder_bwd_bf16_kernel<<<blocks, JOB_THREADS, smem, st>>>(
      x, adj, level, node_mask, edgeless, weights, grad_h, partial,
      (long)B * K, d);
  reduce_blocks_kernel<<<(d.wtotal + 255) / 256, 256, 0, st>>>(
      partial, blocks, d.wtotal, grad);
  return (int)cudaGetLastError();
}

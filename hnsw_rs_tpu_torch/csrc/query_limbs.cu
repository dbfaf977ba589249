// The query limb split alone (sm_90a): the pre-pass that csrc/group_min.cu
// (K2) and csrc/l2_kernel.cu (K1) launch ahead of their kernels, behind an
// entry point of its own so that it can be held against its plain version,
// ops/limbs.query_limbs, and timed. The kernel and its notes are
// csrc/dist_core.cuh's (dist::split_limbs_kernel). It replaces no TPU
// kernel of its own: the Pallas kernels take float queries, and the limbs
// are what K1's and K2's tensor-core redesign takes in their place.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "dist_core.cuh"

// q f32 [B, d] -> limbs s8 [4, B, d_pad], qscale, qsq, qsum f32 [B], on
// `stream`; returns a cudaError_t (0 = ok).
extern "C" int query_limbs_launch(const float* q, int8_t* limbs, float* qscale,
                                  float* qsq, float* qsum, int B, int d,
                                  int d_pad, int fast, void* stream) {
  return dist::split_limbs(q, limbs, qscale, qsq, qsum, B, d, d_pad, fast,
                           (cudaStream_t)stream);
}

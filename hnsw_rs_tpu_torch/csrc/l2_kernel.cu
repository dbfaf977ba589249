// All-pairs squared L2 from float queries to u8 per-vector-quantized points.
//
// Replaces the Pallas TPU kernel hnsw_rs_tpu/ops/pallas/l2_kernel.py
// (pairwise_l2sq_pallas / _l2_kernel). For f32 queries q[B, d] and u8 codes
// c[N, d] quantized per row as x = delta * c + min, it writes
//     out[b, j] = max(|q_b|^2 + |x_j|^2 - 2 (delta_j (q_b . c_j) + min_j sum(q_b)), 0)
// as a dense f32 [B, N] matrix. With fast != 0 each query value is rounded to
// bf16 (round to nearest even) before the product, as the TPU kernel's bf16
// MXU pass does; a bf16 value times a code (an integer <= 255) is exact in
// f32, and the sums stay f32. |q|^2 and sum(q) always use the unrounded q.
//
// What bounds it on an H100: a pair costs 2d FLOP (192 at d=96) against one
// 4-byte output store, 48 FLOP per byte written, above the card's ridge of
// ~20 f32 FLOP per byte (67 TFLOP/s over 3.35 TB/s). Compute bounds it, as it
// bounds the group-min kernel: the B*N*d multiply-adds run in exact f32 on
// the CUDA cores (a TF32 or bf16 tensor-core path would flip near-tie
// orderings). Codes are read once per 64-query tile, mostly from L2.
//
// Design: the register-tiled f32-FMA structure of csrc/group_min.cu. One
// block of 256 threads owns 64 queries x kTPB tiles of 128 rows. The query
// tile is staged once, transposed, as f32 in shared memory; each row tile's
// codes are staged 32 dimensions at a time as f32, [dim][row] with a row
// stride of 129 floats, so the staging threads read consecutive bytes of a
// code row from global memory and write distinct shared-memory banks. Each
// thread owns a 4-query x 8-row micro-tile (rows tx + 16 r) and accumulates
// with fmaf in dimension order; the affine epilogue uses explicitly rounded
// operations in the order of the plain PyTorch version, and |q|^2, sum(q)
// come from the caller (the same PyTorch reductions as the plain version),
// so the only difference from it is the order of the dot-product sums. The
// 16 lanes of a half-warp store 16 consecutive floats of one output row, so
// every warp store covers two full 64-byte runs. Ragged B and N are masked
// in the kernel: no padding, and nothing beyond [B, N] is written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;     // rows per tile
constexpr int kTQ = 64;        // queries per block
constexpr int kKC = 32;        // dimensions staged per step
constexpr int kCS = kRows + 1; // staged-code row stride (bank spread)
constexpr int kThreads = 256;  // 16 row lanes x 16 query quads
constexpr int kTPB = 4;        // row tiles per block

__global__ void __launch_bounds__(kThreads)
l2_kernel(const float* __restrict__ q, const float* __restrict__ qsq,
          const float* __restrict__ qsum, const uint8_t* __restrict__ codes,
          const float* __restrict__ scales, const float* __restrict__ normsq,
          float* __restrict__ out, int B, int N, int d, int fast) {
  extern __shared__ float smem[];
  float* qs = smem;            // [d][kTQ]: qs[k * kTQ + i] = q[q0 + i][k]
  float* cs = smem + d * kTQ;  // [kKC][kCS]: staged codes as f32
  const int tid = threadIdx.x;
  const int tx = tid & 15;     // this thread's rows: tx + 16 * r
  const int ty = tid >> 4;     // this thread's queries: 4 * ty + i
  const int q0 = blockIdx.x * kTQ;
  const int T = (N + kRows - 1) / kRows;
  const int t0 = blockIdx.y * kTPB;

  for (int e = tid; e < kTQ * d; e += kThreads) {
    const int i = e / d, k = e - i * d;
    const int qi = q0 + i;
    float v = qi < B ? q[(size_t)qi * d + k] : 0.f;
    if (fast) v = __bfloat162float(__float2bfloat16_rn(v));
    qs[k * kTQ + i] = v;
  }
  float my_qsq[4], my_qsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    my_qsq[i] = qi < B ? qsq[qi] : 0.f;
    my_qsum[i] = qi < B ? qsum[qi] : 0.f;
  }

  for (int tt = 0; tt < kTPB; ++tt) {
    const int t = t0 + tt;
    if (t >= T) break;  // uniform across the block
    const int row0 = t * kRows;
    const int nrows = min(kRows, N - row0);
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][r] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kKC) {
      const int kc = min(kKC, d - k0);
      __syncthreads();  // cs readers of the previous step are done
      for (int e = tid; e < kRows * kc; e += kThreads) {
        const int r = e / kc, j = e - r * kc;
        cs[j * kCS + r] =
            r < nrows ? (float)codes[(size_t)(row0 + r) * d + k0 + j] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kc; ++j) {
        const float4 a =
            *reinterpret_cast<const float4*>(&qs[(k0 + j) * kTQ + 4 * ty]);
        float b[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) b[r] = cs[j * kCS + tx + 16 * r];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[0][r] = fmaf(a.x, b[r], acc[0][r]);
          acc[1][r] = fmaf(a.y, b[r], acc[1][r]);
          acc[2][r] = fmaf(a.z, b[r], acc[2][r]);
          acc[3][r] = fmaf(a.w, b[r], acc[3][r]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = tx + 16 * r;
      if (row >= nrows) continue;
      const size_t gr = (size_t)row0 + row;
      const float mn = scales[2 * gr], dl = scales[2 * gr + 1];
      const float ns = normsq[gr];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + 4 * ty + i;
        if (qi >= B) continue;
        const float qdotx =
            __fadd_rn(__fmul_rn(dl, acc[i][r]), __fmul_rn(mn, my_qsum[i]));
        const float d2 =
            __fsub_rn(__fadd_rn(my_qsq[i], ns), __fmul_rn(2.f, qdotx));
        out[(size_t)qi * N + gr] = fmaxf(d2, 0.f);
      }
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int pairwise_l2sq_launch(const float* q, const float* qsq,
                                    const float* qsum, const uint8_t* codes,
                                    const float* scales, const float* normsq,
                                    float* out, int B, int N, int d, int fast,
                                    void* stream) {
  const int T = (N + kRows - 1) / kRows;
  const size_t smem = ((size_t)d * kTQ + (size_t)kKC * kCS) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kTQ - 1) / kTQ, (T + kTPB - 1) / kTPB);
  l2_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, qsq, qsum, codes, scales, normsq, out, B, N, d, fast);
  return (int)cudaGetLastError();
}

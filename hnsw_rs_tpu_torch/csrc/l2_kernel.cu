// K1: all-pairs squared L2 from float queries to u8 per-vector-quantized
// points, on the int8 tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel hnsw_rs_tpu/ops/pallas/l2_kernel.py
// (pairwise_l2sq_pallas / _l2_kernel). For f32 queries q[B, d] and u8 codes
// c[N, d] quantized per row as x = delta * c + min, it writes
//     out[b, j] = max(|q_b|^2 + |x_j|^2 - 2 (delta_j (q_b . c_j) + min_j sum(q_b)), 0)
// as a dense f32 [B, N] matrix. With fast=True the limb split rounds q to bf16
// before it takes the limbs, so only the product sees the rounded q;
// |q|^2 and sum(q) always come from the unrounded q.
//
// The product, its exactness argument and the TMA / wgmma pipeline are
// csrc/dist_core.cuh's (query limbs split on the card ahead of it, L = 4). The
// epilogue evaluates the affine form in registers and sends the tile out
// through shared memory: each warp owns 16 queries x 128 rows of the tile
// and stages 32 columns at a time (a 16 x 40-float buffer, the padding
// keeping the fragment writes free of bank conflicts), then writes each
// query's 32 floats as one full 128-byte line with streaming float4
// stores. Ragged B and N are masked at the store (TMA fills the missing
// rows, their scales and norms with zeros), so nothing beyond [B, N] is
// written.
//
// What bounds it on an H100, at B=1024, N=1M, d=96: the output is 4.1 GB,
// 1.22 ms at 3.35 TB/s (codes, scales and norms add 0.1 GB); the product
// is 2 * B * N * 96 * 4 limbs = 7.9e11 int8 operations, 0.40 ms at
// 1,979 TOP/s. So the output write bounds it. The CUDA cores' fold and
// epilogue (~20 instructions per pair, ~0.7 ms of issue) and the tensor
// work sit in each warpgroup's serial chain per tile, beside the stores:
// 2.2-2.3 ms measured, the stores streaming at ~1.8 TB/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "dist_core.cuh"

namespace {

constexpr int kStride = 40;  // floats per staged row

struct Dense {
  static constexpr int kExtraBytes = 4 * dist::kConsumers * 16 * kStride * 4;

  static __device__ __forceinline__ void apply(const dist::Params& p,
                                               const dist::Frag& f, int tile,
                                               uint8_t* extra) {
    float* buf = reinterpret_cast<float*>(extra) + f.warp * 16 * kStride;
    const int row0 = tile * dist::kRows;
    const int c0 = 2 * (f.lane & 3);
    const int r = f.lane >> 2;
    const int q_first = f.q_row[0] - r;  // the warp's first query
    const bool vec = (p.N & 3) == 0;
#pragma unroll
    for (int part = 0; part < 4; ++part) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * part + jj;
        const int col = 8 * j + c0;
        const float2 ns = *reinterpret_cast<const float2*>(f.ns + col);
        const float4 sc = *reinterpret_cast<const float4*>(f.sc + 2 * col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 v;
          v.x = dist::affine_d2(f.qsq[h], f.qsum[h], f.dot[4 * j + 2 * h], sc.x,
                                sc.y, ns.x);
          v.y = dist::affine_d2(f.qsq[h], f.qsum[h], f.dot[4 * j + 2 * h + 1],
                                sc.z, sc.w, ns.y);
          *reinterpret_cast<float2*>(&buf[(r + 8 * h) * kStride + 8 * jj + c0]) = v;
        }
      }
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int row = 4 * rr + (f.lane >> 3);
        const int col = 4 * (f.lane & 7);
        const int qi = q_first + row;
        const int gc = row0 + 32 * part + col;
        const float4 v = *reinterpret_cast<const float4*>(&buf[row * kStride + col]);
        if (qi < p.B && gc < p.N) {
          float* dst = p.out_d + (size_t)qi * p.N + gc;
          if (vec && gc + 3 < p.N) {
            __stcs(reinterpret_cast<float4*>(dst), v);
          } else {
            __stcs(dst, v.x);
            if (gc + 1 < p.N) __stcs(dst + 1, v.y);
            if (gc + 2 < p.N) __stcs(dst + 2, v.z);
            if (gc + 3 < p.N) __stcs(dst + 3, v.w);
          }
        }
      }
      __syncwarp();
    }
  }
};

}  // namespace

// Splits q f32 [B, d] into limbs (dist::split_limbs, into the caller's
// scratch: limbs s8 [4, B, d_pad], qscale, qsq, qsum f32 [B]; d_pad from
// ops/limbs.padded_dim, d <= 768; with `fast` the limbs of q rounded to
// bf16), then launches the kernel behind it on `stream`; returns a
// cudaError_t (0 = ok). codes u8 [N, d_g] (d_g a multiple of 16,
// <= d_pad); out f32 [B, N].
extern "C" int pairwise_l2sq_launch(const float* q, int8_t* limbs, float* qscale,
                                    float* qsq, float* qsum,
                                    const uint8_t* codes, const float* scales,
                                    const float* normsq, float* out, int B,
                                    int N, int d, int d_pad, int d_g, int fast,
                                    void* stream) {
  const int e = dist::split_limbs(q, limbs, qscale, qsq, qsum, B, d, d_pad, fast,
                                  (cudaStream_t)stream);
  if (e != 0) return e;
  dist::Params p = {};
  p.qscale = qscale;
  p.qsq = qsq;
  p.qsum = qsum;
  p.scales = scales;
  p.normsq = normsq;
  p.out_d = out;
  p.B = B;
  p.N = N;
  return dist::launch<Dense>(limbs, codes, p, d_pad, d_g,
                               (cudaStream_t)stream);
}

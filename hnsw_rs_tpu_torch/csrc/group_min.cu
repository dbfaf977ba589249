// K2: fused quantized-L2 distance + per-128-row-group lexicographic minimum,
// on the int8 tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel hnsw_rs_tpu/ops/pallas/l2_groupmin.py
// (group_min_d2 / _kernel). For f32 queries q[B, d] and u8 codes c[N, d]
// quantized per row as x = delta * c + min, it computes
//     d2[b, j] = max(|q_b|^2 + |x_j|^2 - 2 (delta_j (q_b . c_j) + min_j sum(q_b)), 0)
// and writes only each 128-row group's (d2, row) minimum, the smallest row
// winning ties, as out_d / out_i [B, N/128]. The [B, N] matrix never
// reaches device memory.
//
// The product, its exactness argument and the TMA / wgmma pipeline are
// csrc/dist_core.cuh's (query limbs from ops/limbs.py, L = 4). A code tile
// is one group, so the epilogue needs nothing across tiles: each consumer
// thread evaluates the affine form on its 2 queries x 32 columns of the
// 64 x 128 tile with two fused multiply-adds a pair (not the plain
// version's rounding order: d2 agrees within a few ulps of |q|^2 + |x|^2,
// and rows may differ only at such ties), keeps the smaller row on equal
// d2, clamps at 0 once, then the 4 lanes of a quad, which share the two
// queries, reduce with xor shuffles (smaller row on equal d2), and lane 0
// of the quad writes both queries' minima.
//
// What bounds it on an H100, at B=4096, N=1,000,064, d=96: the product is
// 2 * B * N * 96 * 4 limbs = 3.15e12 int8 operations, 1.59 ms at the
// 1,979 TOP/s dense int8 rate; the bytes (codes 96 MB, scales and norms
// 12 MB, the [B, N/128] output 256 MB) take 0.11 ms at 3.35 TB/s. Beside
// the tensor cores, the CUDA cores fold 4 limbs and run the epilogue for
// each of the 4.1e9 (query, row) pairs, ~19 instructions each: ~2.4 ms of
// issue at 4 warp-instructions a clock per SM. Each warpgroup's chain per
// tile is serial (product, wait, fold, four times, then the epilogue), so
// the tensor and CUDA-core work overlap only across the two warpgroups:
// 5.1 ms measured, about their sum plus the waits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "dist_core.cuh"

namespace {

struct GroupMin {
  static constexpr int kExtraBytes = 0;

  static __device__ __forceinline__ void apply(const dist::Params& p,
                                               const dist::Frag& f, int tile,
                                               uint8_t*) {
    const int row0 = tile * dist::kRows;
    const int c0 = 2 * (f.lane & 3);
    // key = (|q|^2 + |x|^2 - 2 min sum(q)) - 2 delta (q.c), two fused
    // multiply-adds a pair; max(., 0) once, on the minimum; four running
    // minima per query keep the compare chains short
    float bd[2][4];
    int br[2][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + c0;
      const float2 ns = *reinterpret_cast<const float2*>(f.ns + col);
      const float4 sc = *reinterpret_cast<const float4*>(f.sc + 2 * col);
      const float m0 = -2.f * sc.x, m1 = -2.f * sc.z;
      const float g0 = -2.f * sc.y, g1 = -2.f * sc.w;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float k0 = fmaf(g0, f.dot[4 * j + 2 * h],
                              fmaf(m0, f.qsum[h], f.qsq[h] + ns.x));
        const float k1 = fmaf(g1, f.dot[4 * j + 2 * h + 1],
                              fmaf(m1, f.qsum[h], f.qsq[h] + ns.y));
        const int c = j & 3;  // columns ascend within each chain: strict <
        if (j < 4 || k0 < bd[h][c]) {
          bd[h][c] = k0;
          br[h][c] = col;
        }
        if (k1 < bd[h][c]) {
          bd[h][c] = k1;
          br[h][c] = col + 1;
        }
      }
    }
    float best_d[2];
    int best_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_d[h] = bd[h][0];
      best_r[h] = br[h][0];
#pragma unroll
      for (int c = 1; c < 4; ++c)
        if (bd[h][c] < best_d[h] ||
            (bd[h][c] == best_d[h] && br[h][c] < best_r[h])) {
          best_d[h] = bd[h][c];
          best_r[h] = br[h][c];
        }
      best_d[h] = fmaxf(best_d[h], 0.f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best_d[h], off);
        const int orow = __shfl_xor_sync(0xffffffffu, best_r[h], off);
        if (od < best_d[h] || (od == best_d[h] && orow < best_r[h])) {
          best_d[h] = od;
          best_r[h] = orow;
        }
      }
      const int qi = f.q_row[h];
      if ((f.lane & 3) == 0 && qi < p.B) {
        const size_t o = (size_t)qi * (p.N / dist::kRows) + tile;
        p.out_d[o] = best_d[h];
        p.out_i[o] = row0 + best_r[h];
      }
    }
  }
};

}  // namespace

// Launches the kernel on `stream` and returns a cudaError_t (0 = ok).
// limbs s8 [4, B, d_pad] and qscale [B] come from ops/limbs.py (d <= 768);
// codes u8 [N, d_g] (d_g a multiple of 16, <= d_pad); N a multiple of
// 128, pad rows carrying normsq = +inf.
extern "C" int group_min_d2_launch(const int8_t* limbs, const float* qscale,
                                   const float* qsq, const float* qsum,
                                   const uint8_t* codes, const float* scales,
                                   const float* normsq, float* out_d,
                                   int32_t* out_i, int B, int N, int d_pad,
                                   int d_g, void* stream) {
  if (N % dist::kRows) return (int)cudaErrorInvalidValue;
  dist::Params p = {};
  p.qscale = qscale;
  p.qsq = qsq;
  p.qsum = qsum;
  p.scales = scales;
  p.normsq = normsq;
  p.out_d = out_d;
  p.out_i = out_i;
  p.B = B;
  p.N = N;
  return dist::launch<GroupMin>(limbs, codes, p, d_pad, d_g,
                                (cudaStream_t)stream);
}

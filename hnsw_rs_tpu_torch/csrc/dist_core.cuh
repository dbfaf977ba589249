// Tensor-core quantized-L2 core shared by csrc/group_min.cu (K2) and
// csrc/l2_kernel.cu (K1), for sm_90a.
//
// Both kernels compute, for f32 queries q[B, d] and u8 codes c[N, d]
// quantized per row as x = delta * c + min,
//     d2[b, j] = max(|q_b|^2 + |x_j|^2 - 2 (delta_j (q_b . c_j) + min_j sum(q_b)), 0)
// and differ only in what they write (an epilogue policy, below).
//
// The product q . c runs exactly on the int8 tensor cores. A pre-pass
// (split_limbs_kernel below; ops/limbs.py is its plain version) launched
// ahead of the main kernel writes each query as L signed 8-bit limbs of a
// fixed-point integer, q_b ~= s_b * sum_l 256^l limb_l with a power-of-two
// s_b and one bit of headroom (|Q_b| <= 2^(8L-2)), so each component is
// off by at most s_b / 2 (~2^-31 of max|q_b| at L = 4). Every limb product
// S_l = sum_k c_k limb_l[k] is one `wgmma ... .s32.s8.u8` chain and is an
// exact int32 (|S_l| <= 255 * 128 * d). The S_l are folded into one f32
// from the top limb down, acc = acc * 256 + S_l (one rounding each), and
// q . c = acc * s_b exactly. The conversions are exact too while
// |S_l| < 2^24 (255 * 128 * d_pad < 2^24 for d_pad <= 512; the top limb,
// |limb| <= 64, stays below it up to the d limit of 768); for
// d_pad <= 128 the add-a-magic-constant conversion is used (|S_l| < 2^22).
// Past d_pad = 512 a lower limb's conversion may round once, as a fold
// step does. So the only roundings are q's representation (~2^-31
// relative), the three fold steps (and those conversions) and the affine
// epilogue, which uses the plain PyTorch version's operations in its
// order. That is why this is exact where a TF32 or single bf16 pass was
// not: those round q (or c) to a 10- or 7-bit mantissa inside the
// product, and near-tie orderings flip.
//
// Feeding: one block per SM (persistent) walks (128-query tile, run of
// 128-row tiles) work items, the same number of tiles for every block.
// Warpgroup 2 is the producer: one thread streams code tiles by TMA into
// a ring of shared-memory stages guarded by full/empty mbarriers. Code
// tiles land as 16-byte columns of 128 rows ([column][row][16 B]), which
// is the no-swizzle K-major core-matrix layout `wgmma` reads directly:
// u8 is a native operand, so nothing is widened or converted. Warpgroups
// 0 and 1 are consumers, 64 queries each: per tile and per limb they run
// a chain of `wgmma.m64n128k32` into one s32 tile, wait, and fold it into
// the f32 tile (64 + 64 registers a thread); then they run the epilogue on
// the CUDA cores and release the stage. The two warpgroups drift apart,
// so one's products overlap the other's folds and epilogue. The tile's
// scales and norms ride in a stage too (two 1-D TMA boxes), so the
// epilogue reads only shared memory.
//
// Two layouts, by d_pad (ops/limbs.padded_dim picks d_pad so that both
// divide it evenly):
// - resident, d_pad <= 256: the item's query limbs (4 x 128 x d_pad
//   bytes, 128 KB at 256) are loaded once per item and stay; a stage is
//   one whole code tile, and each limb's chain is d_pad/32 steps.
// - streamed, 256 < d_pad <= 768: the limbs no longer fit beside a ring
//   (384 KB at 768), so d_pad is cut into n_chunks equal chunks of at
//   most 256 and a stage carries one limb's chunk of the query tile and
//   the code tile's same chunk (at most 64 KB); per tile the producer
//   sends, top limb first, every chunk of each limb, and the consumers
//   chain each limb's chunks into the same s32 tile (one wait per chunk,
//   so the stage can go back) before the fold. The fold order and so the
//   numerics are the resident layout's; the price is that the query tile
//   and each code chunk cross from L2 once per limb and tile.
// The chain length is a compile-time count, one kernel per chunk width.
// (Tried on an H100 with nvcc 12.9 and
// not kept: strict turn-taking between the warpgroups, no faster; two s32
// tiles in flight per warpgroup, so that a fold overlaps the next limb's
// product, which ptxas either serializes (C7515, run-time step loop) or,
// with compile-time steps, schedules the fold's reads of a finished tile
// after the next asynchronous product into it: wrong results.)
//
// TMA needs 16-byte global strides: for d % 16 != 0 the wrapper copies
// the codes to a row stride of d rounded up to 16. The query limbs are
// zero past d, so whatever lies in a code tile's padding multiplies zero.
// Rows past N (K1's ragged edge) and queries past B arrive as TMA's zero
// fill and are masked at the store.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dist {

constexpr int kRows = 128;          // code rows per tile (one K2 group)
constexpr int kQB = 128;            // queries per work item: 2 consumer warpgroups x 64
constexpr int kColBytes = kRows * 16;  // one 16-byte column of a 128-row tile
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kLimbs = 4;         // query limbs (ops/limbs.N_LIMBS)
constexpr int kAuxBytes = kRows * 3 * 4;  // a stage's (min, delta) and |x|^2
constexpr int kChunkDim = 256;    // widest resident d_pad; widest streamed chunk
constexpr int kMaxDim = 768;
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 232448;  // 227 KB of dynamic shared memory per block
constexpr int kBarBytes = 256;

struct Params {
  const float* qscale;  // s_b [B]
  const float* qsq;     // |q_b|^2 [B]
  const float* qsum;    // sum(q_b) [B]
  const float* scales;  // (min, delta) [N, 2]
  const float* normsq;  // |x_j|^2 [N]
  float* out_d;
  int32_t* out_i;
  int B, N;
  int n_cols;    // 16-byte columns of d_pad (d_pad / 16, even)
  int n_cols_g;  // 16-byte columns of the codes' global row stride
  int n_chunks;  // streamed layout: chunks of d_pad (1 when resident)
  int stages;
  int n_tiles;   // ceil(N / 128)
  int n_qt;      // ceil(B / 128)
};

// The work items of one block. The (query tile, row tile) pairs, query
// tile major, are cut into gridDim.x equal runs, one per block; a run
// that crosses a query tile boundary is walked as one item per query tile
// (the query limbs are loaded once per item).
struct Item {
  long long w, w_hi;
  int n_tiles;
  int qt = 0, t_lo = 0, t_hi = 0;
  __device__ explicit Item(const Params& p) : n_tiles(p.n_tiles) {
    const long long total = (long long)p.n_qt * p.n_tiles;
    w = total * blockIdx.x / gridDim.x;
    w_hi = total * (blockIdx.x + 1) / gridDim.x;
  }
  __device__ bool next() {
    if (w >= w_hi) return false;
    qt = (int)(w / n_tiles);
    const long long base = (long long)qt * n_tiles;
    t_lo = (int)(w - base);
    t_hi = (int)(w_hi - base < n_tiles ? w_hi - base : n_tiles);
    w = base + t_hi;
    return true;
  }
};

// -- shared-memory barriers, TMA, wgmma ----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed. A wait
// of more than 10 s can only be a broken pipeline: it traps, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 0xFFFF) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            int c0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Matrix descriptor of a no-swizzle K-major operand: core matrices of
// 8 rows x 16 bytes, rows 16 bytes apart; `lbo` bytes between the two
// 16-byte columns of one k32 step, `sbo` bytes between 8-row groups.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulator across the
// asynchronous product's issue and wait.
__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 32] (s8, shared) * B[32 x 128] (u8, shared), s32.
__device__ __forceinline__ void gmma_m64n128k32_s8u8(int32_t (&d)[64],
                                                     uint64_t da, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
        "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Exact int32 -> f32 for |s| < 2^22: s lands in the mantissa of 1.5 * 2^23.
__device__ __forceinline__ float small_s32_to_f32(int32_t s) {
  return __int_as_float(s + 0x4B400000) - 12582912.0f;
}

// The plain version's epilogue, with its roundings in its order.
__device__ __forceinline__ float affine_d2(float qsq, float qsum, float dot,
                                           float mn, float dl, float ns) {
  const float qdotx = __fadd_rn(__fmul_rn(dl, dot), __fmul_rn(mn, qsum));
  return fmaxf(__fsub_rn(__fadd_rn(qsq, ns), __fmul_rn(2.f, qdotx)), 0.f);
}

// What a consumer thread holds for an epilogue. Fragment slot i of the
// 64 x 128 tile (wgmma's accumulator layout) is query row
// q_row[(i >> 1) & 1] and tile column 8 * (i >> 2) + 2 * (lane & 3) + (i & 1).
struct Frag {
  float dot[64];  // q . c of each slot
  float qsq[2], qsum[2];
  int q_row[2];   // global query index of the two rows (may be >= B)
  int lane;
  int warp;       // consumer warp 0..7
  const float* sc;  // the tile's (min, delta) pairs in shared memory [128][2]
  const float* ns;  // the tile's |x|^2 in shared memory [128]
};

// Issues d[64 x 128] (+)= A_l * B over kSteps k32 steps (d = A_l * B when
// `fresh`). (A compile-time count lets ptxas issue the chain back to
// back; with a run-time loop it waited after each step.)
template <int kSteps>
__device__ __forceinline__ void limb_product(int32_t (&d)[64], uint32_t a_l,
                                             uint32_t b, bool fresh) {
  fence_acc(d);
  gmma_fence();
#pragma unroll
  for (int k = 0; k < kSteps; ++k)
    gmma_m64n128k32_s8u8(d, gmma_desc(a_l + 2 * k * kColBytes, kColBytes, 128),
                         gmma_desc(b + 2 * k * kColBytes, kColBytes, 128),
                         k > 0 || !fresh);
  gmma_commit();
}

template <bool kSmallSums>
__device__ __forceinline__ float s32_to_f32(int32_t s) {
  return kSmallSums ? small_s32_to_f32(s) : __int2float_rn(s);
}

// Waits for d's product, then dot = dot * 256 + d (dot = d for the top limb).
template <bool kSmallSums, bool kTop>
__device__ __forceinline__ void fold(float (&dot)[64], int32_t (&d)[64]) {
  gmma_wait_all();
  fence_acc(d);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    dot[i] = kTop ? s32_to_f32<kSmallSums>(d[i])
                  : fmaf(dot[i], 256.f, s32_to_f32<kSmallSums>(d[i]));
}

// -- the kernel ------------------------------------------------------------------

// Epi provides `static constexpr int kExtraBytes` (shared memory of its
// own, after the stages, a multiple of 16) and a __forceinline__
// `static __device__ void apply(const Params&, const Frag&, int tile, uint8_t* extra)`.
// kSteps is the k32 steps of one chain (the d_pad of a resident layout,
// one chunk of a streamed one).
template <class Epi, int kSteps, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
dist_kernel(const __grid_constant__ CUtensorMap codes_map,
            const __grid_constant__ CUtensorMap limbs_map,
            const __grid_constant__ CUtensorMap scales_map,
            const __grid_constant__ CUtensorMap normsq_map, const Params p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  // one chain's k extent: the whole d_pad (resident), one chunk (streamed)
  const int col_bytes = kStream ? 2 * kSteps * kColBytes : p.n_cols * kColBytes;
  // resident: the query limbs [limb][column][128 queries][16 B], then
  // stages of [column][128 rows][16 B], scales, norms; streamed: stages
  // of one limb's chunk of the query tile, the code tile's chunk, scales,
  // norms (the first design's layout is kept as it was: a shared
  // restructuring of both cost K2 6% on an H100)
  const int stage_bytes = (kStream ? 2 : 1) * col_bytes + kAuxBytes;
  uint8_t* a_tile = smem;
  uint8_t* stage0 = smem + (kStream ? 0 : kLimbs * col_bytes);
  uint8_t* extra = stage0 + p.stages * stage_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(extra + Epi::kExtraBytes);
  uint64_t* full = bars;
  uint64_t* empty = bars + kMaxStages;
  uint64_t* q_full = bars + 2 * kMaxStages;
  uint64_t* q_empty = q_full + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128 && !kStream) {
      const uint32_t tile_bytes = p.n_cols_g * kColBytes + kAuxBytes;
      int it = 0, n = 0;
      for (Item w(p); w.next(); ++n) {
        const int qt = w.qt, t_lo = w.t_lo, t_hi = w.t_hi;
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, kLimbs * col_bytes);
        for (int l = 0; l < kLimbs; ++l)
          for (int c = 0; c < p.n_cols; ++c)
            tma_load_3d(a_tile + (l * p.n_cols + c) * kColBytes, &limbs_map,
                        16 * c, qt * kQB, l, q_full);
        for (int t = t_lo; t < t_hi; ++t, ++it) {
          const int s = it % p.stages;
          mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
          uint8_t* st = stage0 + s * stage_bytes;
          mbar_expect_tx(&full[s], tile_bytes);
          for (int c = 0; c < p.n_cols_g; ++c)
            tma_load_2d(st + c * kColBytes, &codes_map, 16 * c, t * kRows,
                        &full[s]);
          tma_load_1d(st + col_bytes, &scales_map, 2 * kRows * t, &full[s]);
          tma_load_1d(st + col_bytes + 2 * kRows * 4, &normsq_map, kRows * t,
                      &full[s]);
        }
      }
    } else if (threadIdx.x == kConsumers * 128) {
      // streamed: per tile, every chunk of every limb, top limb first; the
      // tile's last stage also carries its scales and norms
      constexpr int kCols = 2 * kSteps;
      const int per_tile = kLimbs * p.n_chunks;
      int it = 0;
      for (Item w(p); w.next();) {
        for (int t = w.t_lo; t < w.t_hi; ++t) {
          for (int k = 0; k < per_tile; ++k, ++it) {
            const int s = it % p.stages;
            mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
            uint8_t* st = stage0 + s * stage_bytes;
            const int l = kLimbs - 1 - k / p.n_chunks;
            const int c0 = (k % p.n_chunks) * kCols;
            const int g_cols = min(max(p.n_cols_g - c0, 0), kCols);
            const bool last = k == per_tile - 1;
            mbar_expect_tx(&full[s], col_bytes + g_cols * kColBytes +
                                         (last ? kAuxBytes : 0));
            for (int c = 0; c < kCols; ++c)
              tma_load_3d(st + c * kColBytes, &limbs_map, 16 * (c0 + c),
                          w.qt * kQB, l, &full[s]);
            for (int c = 0; c < g_cols; ++c)
              tma_load_2d(st + col_bytes + c * kColBytes, &codes_map,
                          16 * (c0 + c), t * kRows, &full[s]);
            if (last) {
              tma_load_1d(st + 2 * col_bytes, &scales_map, 2 * kRows * t,
                          &full[s]);
              tma_load_1d(st + 2 * col_bytes + 2 * kRows * 4, &normsq_map,
                          kRows * t, &full[s]);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 queries each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int wi = (threadIdx.x / 32) & 3;
    Frag f;
    f.lane = lane;
    f.warp = threadIdx.x / 32;
    // |S_l| <= 255 * 128 * d_pad < 2^22 for d_pad <= 128
    constexpr bool kSmallSums = !kStream && kSteps <= 4;
    const uint32_t a_base = smem_u32(a_tile) + wg * 64 * 16;
    int32_t acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    int it = 0, n = 0;
    for (Item w(p); w.next(); ++n) {
      const int qt = w.qt, t_lo = w.t_lo, t_hi = w.t_hi;
      float qs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = qt * kQB + wg * 64 + wi * 16 + (lane >> 2) + 8 * h;
        const bool ok = qi < p.B;
        f.q_row[h] = qi;
        f.qsq[h] = ok ? p.qsq[qi] : 0.f;
        f.qsum[h] = ok ? p.qsum[qi] : 0.f;
        qs[h] = ok ? p.qscale[qi] : 0.f;
      }
      if (!kStream) {
        mbar_wait(q_full, n & 1);
        for (int t = t_lo; t < t_hi; ++t, ++it) {
          const int s = it % p.stages;
          mbar_wait(&full[s], (it / p.stages) & 1);
          uint8_t* st = stage0 + s * stage_bytes;
          const uint32_t b = smem_u32(st);
          // top limb first; while this warpgroup waits or folds, the other
          // warpgroup's products or epilogue keep the SM busy
          limb_product<kSteps>(acc, a_base + 3 * col_bytes, b, true);
          fold<kSmallSums, true>(f.dot, acc);
          for (int l = 2; l >= 0; --l) {
            limb_product<kSteps>(acc, a_base + l * col_bytes, b, true);
            fold<kSmallSums, false>(f.dot, acc);
          }
#pragma unroll
          for (int i = 0; i < 64; ++i) f.dot[i] *= qs[(i >> 1) & 1];
          f.sc = reinterpret_cast<const float*>(st + col_bytes);
          f.ns = f.sc + 2 * kRows;
          Epi::apply(p, f, t, extra);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
      } else {
        for (int t = t_lo; t < t_hi; ++t) {
          // each limb's chunks chain into one s32 tile (a wait per chunk,
          // so its stage can go back), then the fold; the tile's last
          // stage holds its scales and is kept through the epilogue
          int s = 0;
          uint8_t* st = stage0;
          for (int l = kLimbs - 1; l >= 0; --l) {
            for (int c = 0; c < p.n_chunks; ++c, ++it) {
              if (c > 0 || l < kLimbs - 1) {
                __syncwarp();
                if (lane == 0) mbar_arrive(&empty[s]);
              }
              s = it % p.stages;
              st = stage0 + s * stage_bytes;
              mbar_wait(&full[s], (it / p.stages) & 1);
              limb_product<kSteps>(acc, smem_u32(st) + wg * 64 * 16,
                                   smem_u32(st) + col_bytes, c == 0);
              if (c + 1 < p.n_chunks) {
                gmma_wait_all();
                fence_acc(acc);
              }
            }
            if (l == kLimbs - 1) fold<kSmallSums, true>(f.dot, acc);
            else fold<kSmallSums, false>(f.dot, acc);
          }
#pragma unroll
          for (int i = 0; i < 64; ++i) f.dot[i] *= qs[(i >> 1) & 1];
          f.sc = reinterpret_cast<const float*>(st + 2 * col_bytes);
          f.ns = f.sc + 2 * kRows;
          Epi::apply(p, f, t, extra);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
      }
    }
  }
}

// -- host side -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled get_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tensor map over `rank` dims (innermost first), zero fill out of bounds.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                   int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                   const cuuint32_t* box) {
  EncodeTiled enc = get_encoder();
  if (enc == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap codes, limbs, scales, normsq;
};

template <class Epi, int kSteps, bool kStream>
int launch_steps(const Maps& m, const Params& p, int grid, size_t smem,
                 cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      dist_kernel<Epi, kSteps, kStream>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dist_kernel<Epi, kSteps, kStream><<<grid, kThreads, smem, stream>>>(
      m.codes, m.limbs, m.scales, m.normsq, p);
  return (int)cudaGetLastError();
}

// Launches dist_kernel<Epi> on `stream`; returns a cudaError_t (0 = ok).
// limbs: s8 [kLimbs, B, d_pad], d_pad from ops/limbs.padded_dim (a multiple
// of 32; past 256, n_chunks = ceil(d_pad / 256) chunks of a multiple of
// 32); codes: u8 [N, d_g] rows, d_g a multiple of 16 and <= d_pad; every
// base address 16-byte aligned.
template <class Epi>
int launch(const int8_t* limbs, const uint8_t* codes, Params p, int d_pad,
           int d_g, cudaStream_t stream) {
  if (d_pad % 32 || d_pad > kMaxDim || d_g % 16 || d_g > d_pad)
    return (int)cudaErrorInvalidValue;
  const bool streamed = d_pad > kChunkDim;
  p.n_cols = d_pad / 16;
  p.n_cols_g = d_g / 16;
  p.n_chunks = streamed ? (d_pad + kChunkDim - 1) / kChunkDim : 1;
  const int chunk = d_pad / p.n_chunks;
  if (chunk * p.n_chunks != d_pad || chunk % 32) return (int)cudaErrorInvalidValue;
  const int chunk_bytes = chunk / 16 * kColBytes;
  const int fixed = (streamed ? 0 : kLimbs * chunk_bytes) + Epi::kExtraBytes + kBarBytes;
  const int stage_bytes = (streamed ? 2 : 1) * chunk_bytes + kAuxBytes;
  p.stages = (kSmemLimit - fixed) / stage_bytes;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)fixed + (size_t)p.stages * stage_bytes;

  Maps m;
  const cuuint64_t c_dims[2] = {(cuuint64_t)d_g, (cuuint64_t)p.N};
  const cuuint64_t c_strides[1] = {(cuuint64_t)d_g};
  const cuuint64_t l_dims[3] = {(cuuint64_t)d_pad, (cuuint64_t)p.B, kLimbs};
  const cuuint64_t l_strides[2] = {(cuuint64_t)d_pad, (cuuint64_t)d_pad * p.B};
  const cuuint32_t box[3] = {16, (cuuint32_t)kRows, 1};
  const cuuint64_t s_dims[1] = {2 * (cuuint64_t)p.N};
  const cuuint64_t n_dims[1] = {(cuuint64_t)p.N};
  const cuuint32_t s_box[1] = {2 * kRows};
  const cuuint32_t n_box[1] = {kRows};
  if (!encode(&m.codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, 2, c_dims,
              c_strides, box) ||
      !encode(&m.limbs, CU_TENSOR_MAP_DATA_TYPE_UINT8, limbs, 3, l_dims,
              l_strides, box) ||
      !encode(&m.scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.scales, 1, s_dims,
              c_strides, s_box) ||
      !encode(&m.normsq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.normsq, 1, n_dims,
              c_strides, n_box))
    return (int)cudaErrorInvalidValue;

  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  p.n_tiles = (p.N + kRows - 1) / kRows;
  p.n_qt = (p.B + kQB - 1) / kQB;
  const long long pairs = (long long)p.n_qt * p.n_tiles;
  const int grid = pairs < sms ? (int)pairs : sms;

  // one kernel per chain length: 1-8 steps resident, 5-8 streamed (a
  // streamed chunk is wider than 128)
  if (!streamed) {
    switch (chunk / 32) {
      case 1: return launch_steps<Epi, 1, false>(m, p, grid, smem, stream);
      case 2: return launch_steps<Epi, 2, false>(m, p, grid, smem, stream);
      case 3: return launch_steps<Epi, 3, false>(m, p, grid, smem, stream);
      case 4: return launch_steps<Epi, 4, false>(m, p, grid, smem, stream);
      case 5: return launch_steps<Epi, 5, false>(m, p, grid, smem, stream);
      case 6: return launch_steps<Epi, 6, false>(m, p, grid, smem, stream);
      case 7: return launch_steps<Epi, 7, false>(m, p, grid, smem, stream);
      case 8: return launch_steps<Epi, 8, false>(m, p, grid, smem, stream);
    }
  } else {
    switch (chunk / 32) {
      case 5: return launch_steps<Epi, 5, true>(m, p, grid, smem, stream);
      case 6: return launch_steps<Epi, 6, true>(m, p, grid, smem, stream);
      case 7: return launch_steps<Epi, 7, true>(m, p, grid, smem, stream);
      case 8: return launch_steps<Epi, 8, true>(m, p, grid, smem, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// -- the query's limbs, split on the card ---------------------------------------
//
// What ops/limbs.query_limbs computes with a chain of PyTorch operations,
// in one launch, so that a K1 / K2 call costs the host two launches and
// not twenty: one warp per query row takes the row's max |q| (of q rounded
// to bf16 with `fast`), sum(q) and |q|^2 of the unrounded q (shuffle
// reductions), the power-of-two scale 2^(ceil(log2 max) - 30) with the
// exponent floored at -96 and an exact power of two kept one bit below the
// top limb's range, then Q = rint(q / scale) (exact: a multiplication by a
// power of two, ties to even as torch.round) and its balanced base-256
// digits: adding 0x80808080 turns every byte of Q into digit + 128, and
// flipping the byte's top bit reads it back as the int8 digit. Each lane
// packs 4 columns of a limb into one 32-bit store; columns past d are
// zero. limbs s8 [kLimbs, B, d_pad]; the limbs and the scale equal the
// plain version's bit for bit, the two sums are taken in the warp's order.
// It is bound by its bytes (4 B d read, 4 B d_pad written) and by launch
// cost at small B.
constexpr int kSplitWarps = 4;  // query rows per block

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(32 * kSplitWarps)
split_limbs_kernel(const float* __restrict__ q, int8_t* __restrict__ limbs,
                   float* __restrict__ qscale, float* __restrict__ qsq,
                   float* __restrict__ qsum, int B, int d, int d_pad, int fast) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // a whole warp leaves together
  const float* qr = q + (size_t)row * d;
  float m = 0.f, s = 0.f, ss = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float v = qr[k];
    s += v;
    ss += v * v;
    m = fmaxf(m, fabsf(fast ? round_bf16(v) : v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  // ceil(log2 m): m = mant * 2^ex with mant in [0.5, 1), and m is 2^(ex-1)
  // exactly when mant == 0.5; frexp(0) is (0, 0)
  int ex;
  const float mant = frexpf(m, &ex);
  int e = ex - (mant == 0.5f ? 1 : 0);
  e = e < -96 ? -96 : e;
  const int shift = e - (8 * kLimbs - 2);  // in [-126, 98]: both powers normal
  const float inv = __int_as_float((127 - shift) << 23);
  if (lane == 0) {
    qscale[row] = __int_as_float((127 + shift) << 23);
    qsq[row] = ss;
    qsum[row] = s;
  }
  const size_t limb_words = (size_t)B * d_pad / 4;
  uint32_t* out = reinterpret_cast<uint32_t*>(limbs) + (size_t)row * d_pad / 4;
  for (int t = lane; t < d_pad / 4; t += 32) {
    uint32_t w[kLimbs];
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) w[l] = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = 4 * t + c;
      float v = k < d ? qr[k] : 0.f;
      if (fast) v = round_bf16(v);
      const uint32_t u =
          ((uint32_t)__float2int_rn(v * inv) + 0x80808080u) ^ 0x80808080u;
#pragma unroll
      for (int l = 0; l < kLimbs; ++l) w[l] |= ((u >> (8 * l)) & 0xffu) << (8 * c);
    }
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) out[l * limb_words + t] = w[l];
  }
}

// Launches the limb split on `stream`; returns a cudaError_t (0 = ok).
inline int split_limbs(const float* q, int8_t* limbs, float* qscale, float* qsq,
                       float* qsum, int B, int d, int d_pad, int fast,
                       cudaStream_t stream) {
  if (B <= 0) return 0;
  if (d < 0 || d_pad % 32 || d_pad < d) return (int)cudaErrorInvalidValue;
  split_limbs_kernel<<<(B + kSplitWarps - 1) / kSplitWarps, 32 * kSplitWarps, 0,
                       stream>>>(q, limbs, qscale, qsq, qsum, B, d, d_pad, fast);
  return (int)cudaGetLastError();
}

}  // namespace dist

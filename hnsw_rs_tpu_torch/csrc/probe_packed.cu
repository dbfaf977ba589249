// K4: the probed seed stage (M5) of the packed probe route, a query chunk's
// whole stage in one launch (sm_90a).
//
// It replaces no TPU kernel. The JAX package leaves this stage to XLA: it
// scores the probed shortlist rows with plain array code and reduces the pool
// with approx_max_k in hnsw_rs_tpu/search.py:_top_ef_dedup_oversampled. The
// port ran it as search._probe_seeds over search._score_probe_packed and
// search._top_ef_dedup_oversampled: per chunk, a Python loop over the probes
// with a dequantize and a diff-square pass per 64 members, a torch.cat of the
// [b, ef' + probes*T] pool, and two sorts, about 4,000 small launches a call.
//
// What it computes is that function, query by query. The pool is [the ef'
// seeds | probe 0's T members | ... | probe np-1's], np = min(probes, the
// width of pos), in that order; a member is read from the packed shortlist
// row of its pivot (search.pack_layer's layout: codes | (min, delta) pairs |
// ids) and scored as ops/distance.l2sq(q, ops/quant.dequantize(...)) does:
// x = codes*delta + min with two roundings, each difference and each square
// rounded on its own (intrinsics, so nothing is contracted to an fma); only
// the order of the sum differs. A member with id -1 is (+inf, PAD). Then,
// with s = min(4*ef, pool width): when the pool is wider than s, its s lowest
// entries by (d2, pool position) (ops/topk.topk_lowest's order, exact at the
// boundary), of which each id keeps its lowest (d2, position) entry (what
// dedup_ids keeps of topk_lowest's output); otherwise the whole pool, of
// which each id keeps its first position (dedup_ids on the pool itself). A
// dropped duplicate becomes (+inf, PAD). The survivors sorted by (d2, id),
// the first min(ef, pool width) written out.
//
// What bounds it on an H100: the bytes of the gathered rows. A query reads np
// rows of T*(d+12) bytes: at T 256, d 96 and 36 probes 36 x 27,648 B = 0.995
// MB, so a 10,000-query call reads 9.95 GB (2.97 ms at 3.35 TB/s); the
// arithmetic, ~7 f32 instructions a code byte, is under that on 132 SMs.
//
// Design. One block of 256 threads takes one query at a time from an atomic
// counter (a persistent grid, as K3). The rows stream through two stages in
// shared memory with cp.async (16-byte chunks where the row's sections allow):
// the next probe's row loads while the current one is scored, one member a
// thread, its code bytes read 16 at a time and turned into floats exactly
// (0x4b000000 | byte, less 2^23). The pool holds only the d2 keys, one word a
// slot (the slot is the position), so the shared memory stays under 100 KB at
// the cells' shape and two blocks share an SM: one block's selection overlaps
// the other's loads. The selection is a radix select of the s-th key (the
// float bits order as unsigned integers, since d2 >= 0 or +inf; -0 counts as
// 0) in three passes of 11, 11 and 10 bits over 2,048-bin histograms, then
// a compaction in position order (a block scan), which keeps of the entries
// equal to the s-th key the first ones by position. Only the <= s survivors'
// ids are read back from the rows (device memory, mostly L2). The dedup is an
// open-addressing table in shared memory (load <= 3/4) whose slots keep each
// id's least 64-bit key, (d2 << 32 | position) or the position alone, by
// atomicMin; a bitonic sort of (d2 << 32 | id) over the next power of two
// orders the survivors. Nothing is allocated; every scratch area aliases the
// row stages, which are idle by then.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 0x7fffffff;  // ops/topk.PAD_ID
constexpr int kMaxDim = 768;      // ops/cuda_build.MAX_DIM
constexpr int kMaxT = 4096;
constexpr int kMaxEf = 4096;
constexpr int kMaxPool = 65535;   // the compaction scan packs two counts
constexpr int kMaxSmem = 231424;  // dynamic bytes: 227 KB less 1 KB
constexpr int kBins = 2048;       // radix digits of 11 bits
constexpr unsigned kInfKey = 0x7f800000u;

struct Params {
  const uint8_t* pack;
  long long P;
  int T, d;
  const float* q;
  const float* seed_d2;
  const int* seed_ids;
  int E;
  const long long* pos;
  int Epos, np, B, ef;
  float* out_d2;
  int* out_ids;
  int* work;
};

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline int pow2ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Byte offsets of the dynamic shared memory (ops/probe.smem_bytes mirrors
// it): the query, the pool's keys, then the work area: two row stages, or
// the selection's scratch (the survivors' key, position and id, then the
// radix histogram, the dedup table or the sort keys).
struct Layout {
  int W, s, H, P2, q, pool, work, stage, off_s, off_i, sv, tail, bytes;
};

__host__ __device__ inline Layout layout(int T, int d, int E, int np, int ef) {
  Layout L;
  L.W = E + np * T;
  L.s = 4 * ef < L.W ? 4 * ef : L.W;
  L.H = pow2ceil((4 * L.s + 2) / 3);
  L.P2 = pow2ceil(L.s);
  L.q = 0;
  L.pool = up16(4 * d);
  L.work = L.pool + up16(4 * L.W);
  L.off_s = up16(T * d);
  L.off_i = L.off_s + up16(8 * T);
  L.stage = L.off_i + up16(4 * T);
  L.sv = up16(4 * L.s);
  int tail = 12 * L.H;
  if (8 * L.P2 > tail) tail = 8 * L.P2;
  if (4 * kBins > tail) tail = 4 * kBins;
  L.tail = 3 * L.sv;
  const int scratch = L.tail + tail;
  L.bytes = L.work + (2 * L.stage > scratch ? 2 * L.stage : scratch);
  return L;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `nbytes` from global `src` to shared `dst` with the widest chunk that
// both addresses and the length allow; cp.async for 4 bytes and up.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int nbytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst) | (uintptr_t)nbytes;
  const int w = (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : 1;
  if (w == 1) {
    for (int i = threadIdx.x; i < nbytes; i += kThreads) dst[i] = src[i];
    return;
  }
  for (int i = threadIdx.x * w; i < nbytes; i += kThreads * w)
    cp_async(dst + i, src + i, w);
}

// A 4-byte little-endian int at any byte address.
__device__ __forceinline__ int load_i32(const uint8_t* a) {
  if ((reinterpret_cast<uintptr_t>(a) & 3) == 0)
    return __ldg(reinterpret_cast<const int*>(a));
  return (int)((unsigned)a[0] | ((unsigned)a[1] << 8) | ((unsigned)a[2] << 16) |
               ((unsigned)a[3] << 24));
}

// The order key of a d2 >= 0: its bits, with -0 as 0.
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(f);
  return u == 0x80000000u ? 0u : u;
}

// One term of the sum: byte `i` of `w` dequantized and its difference to `qk`
// squared, each step rounded on its own.
__device__ __forceinline__ float term(float acc, unsigned w, int i, float qk,
                                      float mn, float delta) {
  const float c = __fsub_rn(
      __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440u | i)), 8388608.f);
  const float e = __fsub_rn(qk, __fadd_rn(__fmul_rn(c, delta), mn));
  return __fadd_rn(acc, __fmul_rn(e, e));
}

__device__ __forceinline__ float term4(float acc, unsigned w, float4 qq,
                                       float mn, float delta) {
  acc = term(acc, w, 0, qq.x, mn, delta);
  acc = term(acc, w, 1, qq.y, mn, delta);
  acc = term(acc, w, 2, qq.z, mn, delta);
  return term(acc, w, 3, qq.w, mn, delta);
}

// Exclusive prefix sum of `v` over the block; `total` gets the sum. Holds
// two block barriers.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* s_warp,
                                               unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  unsigned before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned t = s_warp[w];
    before += w < warp ? t : 0;
    all += t;
  }
  *total = all;
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads, 2) probe_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_sel[2];
  __shared__ int s_q;

  const int tid = threadIdx.x;
  const int T = p.T, d = p.d, E = p.E, np = p.np;
  const Layout L = layout(T, d, E, np, p.ef);
  const int W = L.W, s = L.s;
  const bool topk = W > s;
  const int efo = p.ef < W ? p.ef : W;
  const int hbits = __ffs(L.H) - 1;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  unsigned* pool = reinterpret_cast<unsigned*>(smem + L.pool);
  uint8_t* work = smem + L.work;
  unsigned* skey = reinterpret_cast<unsigned*>(work);
  unsigned* spos = reinterpret_cast<unsigned*>(work + L.sv);
  int* sid = reinterpret_cast<int*>(work + 2 * L.sv);
  uint8_t* tail = work + L.tail;
  unsigned* hist = reinterpret_cast<unsigned*>(tail);
  unsigned long long* hkey = reinterpret_cast<unsigned long long*>(tail);
  int* hid = reinterpret_cast<int*>(tail + 8 * L.H);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(tail);
  const long long rowW = (long long)T * (d + 12);

  for (;;) {
    if (tid == 0) s_q = atomicAdd(p.work, 1);
    __syncthreads();
    const int qi = s_q;
    if (qi >= p.B) break;
    const long long* ppos = p.pos + (size_t)qi * p.Epos;
    auto row_of = [&](int r) {
      long long v = ppos[r];
      v = v < 0 ? 0 : (v >= p.P ? p.P - 1 : v);
      return p.pack + v * rowW;
    };
    auto stage_row = [&](int r) {
      const uint8_t* src = row_of(r);
      uint8_t* dst = work + (r & 1) * L.stage;
      stage(dst, src, T * d);
      stage(dst + L.off_s, src + (size_t)T * d, 8 * T);
      stage(dst + L.off_i, src + (size_t)T * (d + 8), 4 * T);
    };

    // -- the pool: the seeds, then each probed row scored as it lands
    for (int r = 0; r < 2; ++r) {
      if (r < np) stage_row(r);
      cp_commit();
    }
    for (int k = tid; k < d; k += kThreads) qs[k] = p.q[(size_t)qi * d + k];
    for (int i = tid; i < E; i += kThreads)
      pool[i] = key_of(p.seed_d2[(size_t)qi * E + i]);
    for (int r = 0; r < np; ++r) {
      cp_wait<1>();
      __syncthreads();  // row r is in its stage (and the query, at r = 0)
      const uint8_t* st = work + (r & 1) * L.stage;
      const float* sc = reinterpret_cast<const float*>(st + L.off_s);
      const int* ids = reinterpret_cast<const int*>(st + L.off_i);
      for (int j = tid; j < T; j += kThreads) {
        unsigned key = kInfKey;
        if (ids[j] >= 0) {
          const uint8_t* c = st + (size_t)j * d;
          const float mn = sc[2 * j], delta = sc[2 * j + 1];
          float acc = 0.f;
          if ((d & 15) == 0) {
            for (int k = 0; k < d; k += 16) {
              const uint4 w = *reinterpret_cast<const uint4*>(c + k);
              acc = term4(acc, w.x, *reinterpret_cast<const float4*>(qs + k),
                          mn, delta);
              acc = term4(acc, w.y,
                          *reinterpret_cast<const float4*>(qs + k + 4), mn,
                          delta);
              acc = term4(acc, w.z,
                          *reinterpret_cast<const float4*>(qs + k + 8), mn,
                          delta);
              acc = term4(acc, w.w,
                          *reinterpret_cast<const float4*>(qs + k + 12), mn,
                          delta);
            }
          } else if ((d & 3) == 0) {
            for (int k = 0; k < d; k += 4)
              acc = term4(acc, *reinterpret_cast<const unsigned*>(c + k),
                          *reinterpret_cast<const float4*>(qs + k), mn, delta);
          } else {
            for (int k = 0; k < d; ++k)
              acc = term(acc, (unsigned)c[k], 0, qs[k], mn, delta);
          }
          key = key_of(acc);
        }
        pool[E + r * T + j] = key;
      }
      __syncthreads();  // the stage is free again
      if (r + 2 < np) stage_row(r + 2);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();  // the pool is whole

    // -- the s-th key by (key, position): vstar, and how many equal to it
    //    are kept (need), the first by position
    unsigned vstar = 0xffffffffu, need = 0;
    if (topk) {
      unsigned prefix = 0, mask = 0, rank = (unsigned)s;
      for (int pass = 0; pass < 3; ++pass) {
        const int sh = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
        const unsigned dmask = pass == 2 ? 0x3ffu : 0x7ffu;
        for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
        __syncthreads();
        for (int i = tid; i < W; i += kThreads) {
          const unsigned k = pool[i];
          if ((k & mask) == prefix) atomicAdd(&hist[(k >> sh) & dmask], 1u);
        }
        __syncthreads();
        constexpr int per = kBins / kThreads;
        unsigned sum = 0;
#pragma unroll
        for (int b = 0; b < per; ++b) sum += hist[tid * per + b];
        unsigned all;
        const unsigned before = block_scan(sum, s_warp, &all);
        if (before < rank && rank <= before + sum) {
          unsigned c = before;
          for (int b = 0; b < per; ++b) {
            const unsigned h = hist[tid * per + b];
            if (c + h >= rank) {
              s_sel[0] = tid * per + b;
              s_sel[1] = c;
              break;
            }
            c += h;
          }
        }
        __syncthreads();
        prefix |= s_sel[0] << sh;
        mask |= dmask << sh;
        rank -= s_sel[1];
      }
      vstar = prefix;
      need = rank;
    }

    // -- the survivors, in position order
    {
      const int per = (W + kThreads - 1) / kThreads;
      const int lo = min(W, tid * per), hi = min(W, lo + per);
      unsigned nless = 0, neq = 0;
      for (int i = lo; i < hi; ++i) {
        const unsigned k = pool[i];
        nless += k < vstar;
        neq += k == vstar;
      }
      unsigned all;
      const unsigned before = block_scan((nless << 16) | neq, s_warp, &all);
      unsigned eq = before & 0xffffu;
      unsigned out = (before >> 16) + min(eq, need);
      for (int i = lo; i < hi; ++i) {
        const unsigned k = pool[i];
        bool keep = k < vstar;
        if (k == vstar) keep = eq++ < need;
        if (keep) {
          skey[out] = k;
          spos[out] = (unsigned)i;
          ++out;
        }
      }
    }
    for (int i = tid; i < L.H; i += kThreads) {
      hkey[i] = ~0ull;
      hid[i] = -1;
    }
    __syncthreads();  // s survivors listed, the table empty

    // their ids, read back from the seeds and the rows
#pragma unroll 4
    for (int k = tid; k < s; k += kThreads) {
      const int i = (int)spos[k];
      int id;
      if (i < E) {
        id = __ldg(p.seed_ids + (size_t)qi * E + i);
      } else {
        const int r = (i - E) / T, j = (i - E) - r * T;
        id = load_i32(row_of(r) + (size_t)T * (d + 8) + 4 * j);
        if (id < 0) id = kPad;
      }
      sid[k] = id;
    }
    __syncthreads();

    // -- the dedup: each id keeps its least (d2, position), or position
    for (int k = tid; k < s; k += kThreads) {
      const int id = sid[k];
      const unsigned long long dk =
          topk ? ((unsigned long long)skey[k] << 32 | spos[k]) : spos[k];
      int h = (int)(((unsigned)id * 2654435761u) >> (32 - hbits));
      for (;; h = (h + 1) & (L.H - 1)) {
        const int prev = atomicCAS(&hid[h], -1, id);
        if (prev == -1 || prev == id) break;
      }
      atomicMin(&hkey[h], dk);
    }
    __syncthreads();
    for (int k = tid; k < s; k += kThreads) {
      const int id = sid[k];
      const unsigned long long dk =
          topk ? ((unsigned long long)skey[k] << 32 | spos[k]) : spos[k];
      int h = (int)(((unsigned)id * 2654435761u) >> (32 - hbits));
      while (hid[h] != id) h = (h + 1) & (L.H - 1);
      if (hkey[h] != dk) {
        skey[k] = kInfKey;
        sid[k] = kPad;
      }
    }
    __syncthreads();  // the table is read: its bytes become the sort keys

    // -- the survivors sorted by (d2, id): a bitonic sort of P2 keys
    for (int k = tid; k < L.P2; k += kThreads)
      keys[k] = k < s ? ((unsigned long long)skey[k] << 32 | (unsigned)sid[k])
                      : ~0ull;
    __syncthreads();
    for (int k = 2; k <= L.P2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < (L.P2 >> 1); i += kThreads) {
          const int a = 2 * i - (i & (j - 1)), b = a + j;
          const unsigned long long x = keys[a], y = keys[b];
          if ((x > y) == ((a & k) == 0)) {
            keys[a] = y;
            keys[b] = x;
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < efo; i += kThreads) {
      const unsigned long long k = keys[i];
      p.out_d2[(size_t)qi * efo + i] = __uint_as_float((unsigned)(k >> 32));
      p.out_ids[(size_t)qi * efo + i] = (int)(unsigned)(k & 0xffffffffu);
    }
    __syncthreads();  // before the next query overwrites the state
  }
}

}  // namespace

// The probe stage of every query (probe_packed.cu's note): pack u8 [P,
// T*(d+12)], q f32 [B, d], seeds f32 / i32 [B, E], pos i64 [B, Epos]; np =
// min(probes, Epos) rows a query. Writes out_d2 f32 / out_ids i32 [B, min(ef,
// E + np*T)] and uses work i32 [1] (zeroed here: the query counter). Launches
// on `stream`; returns a cudaError_t (0 = ok). Shapes past the kernel's
// limits return cudaErrorInvalidValue.
extern "C" int probe_packed_launch(const uint8_t* pack, long long P, int T,
                                   int d, const float* q, const float* seed_d2,
                                   const int* seed_ids, int E,
                                   const long long* pos, int Epos, int probes,
                                   int B, int ef, float* out_d2, int* out_ids,
                                   int* work, void* stream) {
  if (probes < 0 || Epos < 0) return cudaErrorInvalidValue;
  const int np = probes < Epos ? probes : Epos;
  if (T < 1 || T > kMaxT || d < 1 || d > kMaxDim || ef < 1 || ef > kMaxEf ||
      E < 1 || E > kMaxPool || B < 1 || P < 1 ||
      (long long)E + (long long)np * T > kMaxPool)
    return cudaErrorInvalidValue;
  const Layout L = layout(T, d, E, np, ef);
  if (L.bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(probe_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                L.bytes)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel,
                                                         kThreads, L.bytes)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((e = cudaMemsetAsync(work, 0, sizeof(int), st)) != cudaSuccess) return e;
  Params p = {pack, P, T, d, q, seed_d2, seed_ids, E, pos, Epos, np, B, ef,
              out_d2, out_ids, work};
  const int grid = B < per_sm * sms ? B : per_sm * sms;
  probe_kernel<<<grid, kThreads, L.bytes, st>>>(p);
  return cudaGetLastError();
}

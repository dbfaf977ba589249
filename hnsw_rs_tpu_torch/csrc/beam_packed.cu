// K3: the packed layer-0 beam (M1), each query's whole walk in one launch
// (sm_90a).
//
// It replaces no TPU kernel. It replaces the lax.while_loop of the JAX
// package's hnsw_rs_tpu/search.py:_beam_loop at E=1, which the port ran as
// search._beam_loop: a Python loop of ~85 small PyTorch launches and one
// blocking host read of the convergence flag per iteration, for every query
// of the batch in lockstep.
//
// What it computes is that loop's function at E=1, query by query. Per query:
// a flagged beam of ef (d2, id) entries sorted by (d2, id), the expanded flag
// packed into the id's low bit (2*id + exp, PAD unchanged: search._pack_exp_id);
// the pop takes the first unexpanded slot; the fetch reads one packed row of
// cap*(d+12) bytes (codes | (min, delta) pairs | ids: search.pack_layer) and
// decodes x = codes*delta + min in float32 with two roundings, as
// ops/quant.dequantize does; the distance is float32 sum (q - x)^2 with each
// difference and each square rounded as ops/distance.l2sq rounds them
// (intrinsics, so nothing is contracted to an fma; only the order of
// summation differs); a neighbour is known if its id is in the beam
// or in the ring of the last `ring` slot writes, and each expansion writes cap
// slots, the new ids and PAD elsewhere (a circular buffer whose write head
// moves back by cap per expansion holds exactly the loop's
// cat([new, ring[:, :ring-cap]]) as a set); the new entries enter by a (d2, id)
// merge truncated at ef; the walk stops when no entry is unexpanded or after
// max_iters expansions. `forbid` (one id per query, or none) is never valid.
// In the lockstep loop a converged query never becomes active again, so a
// per-query loop gives the same beams; a query here stops on its own.
//
// Two equal (d2, id) entries (only a duplicate entry id can make them) are
// ordered unexpanded first by the loop's stable re-sort; the pop flags the last
// of such a run, which keeps the beam sorted by (d2, packed id) without the
// re-sort.
//
// Design. One block of 128 threads walks one query at a time; a persistent
// grid of min(B, SMs x resident blocks) blocks takes query indices from an
// atomic counter, so a short walk frees its block for the next query. All
// state is in shared memory (the query, two beam buffers, the ring, the row's
// codes and scales, a 256-slot table of the row's ids, the new entries): 15 KB
// at ef 384, d 96, cap 48. Per iteration: the pop (the first unexpanded slot is
// kept up to date by the merge); each neighbour's thread reads its id from
// device memory and enters it in the table (open addressing) while the codes
// and scales are staged with cp.async (16-byte chunks where the row's sections
// allow, else 8, 4 or plain bytes); the known test turned around: each of the
// ef + ring ids of the beam and the ring looks itself up in the table and marks
// what it finds, ~(ef + ring) / 128 probes a thread instead of cap x (ef +
// ring) compares; the new entries compacted, one warp per entry for the
// distance (shuffle reduction); a rank sort of the <= cap new entries; a merge
// by ranks (each beam entry moves by the count of new entries below it, each
// new entry lands at its rank plus the count of beam entries at or below it,
// found by binary search) into the other beam buffer. Six block barriers per
// iteration; nothing of size B x cap x ef is ever allocated.
//
// What bounds it on an H100: the bytes are the rows fetched, B x iterations x
// cap*(d+12): 10,000 x 8 x 6,720 B = 0.54 GB (0.16 ms at 3.35 TB/s) at ef 16,
// d 128, cap 48; 10,000 x ~450 x 5,184 B = 23 GB (~7 ms) at ef 384, d 96. One
// query alone is bound by its chain of dependent row fetches, one device-memory
// round trip (~1 us) per expansion: ~8-10 us for 8 expansions. Between the
// fetches, the merge's binary searches and the distances are the largest part
// of the instructions.
//
// Counters: work[0] is the query counter, work[1] the largest per-query
// expansion count (the lockstep loop's iteration count). With a tally
// (u64[1 + 2*cap]) the kernel adds the expansions (live lanes), then per row
// slot the valid and the new neighbours, the layout of search._beam_merge's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kPad = 0x7fffffff;  // ops/topk.PAD_ID
constexpr int kMaxCap = 128;
constexpr int kMaxDim = 768;  // ops/cuda_build.MAX_DIM
constexpr int kMaxEf = 4096;
constexpr int kMaxRing = 8192;
constexpr int kTable = 256;  // the row's ids, open addressing: load <= 1/2
constexpr int kEmpty = -1;

struct Params {
  const uint8_t* packed;
  long long n;
  int cap, d;
  const float* q;
  const float* entry_d2;
  const int* entry_ids;
  int k0;
  const int* forbid;
  int B, ef, max_iters, ring;
  float* out_d2;
  int* out_ids;
  int* work;
  unsigned long long* tally;
};

// Byte offsets of the dynamic shared memory, each 16-aligned.
struct Layout {
  int q, d2a, pka, d2b, pkb, ring, row, off_s, tab, hit, nslot, npk, nd2, spk,
      sd2, bytes;
};

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int cap, int d, int ef, int ring) {
  Layout L;
  int o = 0;
  L.q = o;     o += up16(4 * d);
  L.d2a = o;   o += up16(4 * ef);
  L.pka = o;   o += up16(4 * ef);
  L.d2b = o;   o += up16(4 * ef);
  L.pkb = o;   o += up16(4 * ef);
  L.ring = o;  o += up16(4 * ring);
  L.off_s = up16(cap * d);
  L.row = o;   o += L.off_s + up16(8 * cap);
  L.tab = o;   o += 4 * kTable;
  L.hit = o;   o += 4 * kTable;
  L.nslot = o; o += up16(4 * cap);
  L.npk = o;   o += up16(4 * cap);
  L.nd2 = o;   o += up16(4 * cap);
  L.spk = o;   o += up16(4 * cap);
  L.sd2 = o;   o += up16(4 * cap);
  L.bytes = o;
  return L;
}

__device__ __forceinline__ bool key_less(float da, int pa, float db, int pb) {
  return da < db || (da == db && pa < pb);
}

__device__ __forceinline__ bool unexpanded(int pk) {
  return pk != kPad && (pk & 1) == 0;
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

__device__ __forceinline__ int slot_of(int id) {
  return (int)(((unsigned)id * 2654435761u) >> 24);  // kTable = 2^8
}

// Marks `id`'s slot in the table of the row's ids, if it is there.
__device__ __forceinline__ void mark(const int* tab, int* hit, int id) {
  for (int h = slot_of(id);; h = (h + 1) & (kTable - 1)) {
    const int t = tab[h];
    if (t == id) {
      hit[h] = 1;
      return;
    }
    if (t == kEmpty) return;
  }
}

// A 4-byte little-endian int at any byte address.
__device__ __forceinline__ int load_i32(const uint8_t* a) {
  if ((reinterpret_cast<uintptr_t>(a) & 3) == 0)
    return __ldg(reinterpret_cast<const int*>(a));
  return (int)((unsigned)a[0] | ((unsigned)a[1] << 8) | ((unsigned)a[2] << 16) |
               ((unsigned)a[3] << 24));
}

__global__ void __launch_bounds__(kThreads, 8) beam_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_q, s_first, s_nnew;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cap = p.cap, d = p.d, ef = p.ef, R = p.ring;
  const Layout L = layout(cap, d, ef, R);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* const d2a = reinterpret_cast<float*>(smem + L.d2a);
  float* const d2b = reinterpret_cast<float*>(smem + L.d2b);
  int* const pka = reinterpret_cast<int*>(smem + L.pka);
  int* const pkb = reinterpret_cast<int*>(smem + L.pkb);
  int* ring = reinterpret_cast<int*>(smem + L.ring);
  uint8_t* row = smem + L.row;
  const float* rscale = reinterpret_cast<const float*>(row + L.off_s);
  int* tab = reinterpret_cast<int*>(smem + L.tab);
  int* hit = reinterpret_cast<int*>(smem + L.hit);
  int* nslot = reinterpret_cast<int*>(smem + L.nslot);
  int* npk = reinterpret_cast<int*>(smem + L.npk);
  float* nd2 = reinterpret_cast<float*>(smem + L.nd2);
  int* spk = reinterpret_cast<int*>(smem + L.spk);
  float* sd2 = reinterpret_cast<float*>(smem + L.sd2);

  const long long W = (long long)cap * (d + 12);

  unsigned long long t_valid = 0, t_new = 0, t_live = 0;
  for (int i = tid; i < kTable; i += kThreads) {
    tab[i] = kEmpty;
    hit[i] = 0;
  }

  for (;;) {
    if (tid == 0) {
      s_q = atomicAdd(&p.work[0], 1);
      s_first = ef;
    }
    __syncthreads();
    const int qi = s_q;
    if (qi >= p.B) break;

    // -- init: the query, the sorted beam (rank sort of the entries), the ring
    for (int k = tid; k < d; k += kThreads) qs[k] = p.q[(size_t)qi * d + k];
    const float* ed = p.entry_d2 + (size_t)qi * p.k0;
    const int* ei = p.entry_ids + (size_t)qi * p.k0;
    for (int i = tid; i < p.k0; i += kThreads) {
      const float di = __ldg(ed + i);
      const int ii = __ldg(ei + i);
      const int pi = ii == kPad ? kPad : 2 * ii;
      int rank = 0;
      for (int j = 0; j < p.k0; ++j) {
        const float dj = __ldg(ed + j);
        const int ij = __ldg(ei + j);
        const int pj = ij == kPad ? kPad : 2 * ij;
        rank += key_less(dj, pj, di, pi) || (dj == di && pj == pi && j < i);
      }
      if (rank < ef) {
        d2a[rank] = di;
        pka[rank] = pi;
        if (unexpanded(pi)) atomicMin(&s_first, rank);
      }
    }
    for (int i = p.k0 + tid; i < ef; i += kThreads) {
      d2a[i] = __int_as_float(0x7f800000);
      pka[i] = kPad;
    }
    for (int i = tid; i < R; i += kThreads) ring[i] = i < p.k0 ? __ldg(ei + i) : kPad;
    const int forb = p.forbid ? __ldg(p.forbid + qi) : -1;
    int it = 0, head = 0, cur = 0;
    __syncthreads();

    for (;;) {
      const int first = s_first;
      if (first >= ef || it >= p.max_iters) break;
      float* d2c = cur ? d2b : d2a;
      int* pkc = cur ? pkb : pka;
      const int cand = pkc[first] >> 1;
      if (tid == 0) {
        // flag the last of a run of equal (d2, packed id) entries
        int last = first;
        while (last + 1 < ef && d2c[last + 1] == d2c[first] &&
               pkc[last + 1] == pkc[first])
          ++last;
        pkc[last] |= 1;
      }
      const long long r = cand < 0 ? 0 : (cand >= p.n ? p.n - 1 : cand);
      const uint8_t* src = p.packed + r * W;
      // neighbour `tid` reads its id and enters it in the table
      int nb = kEmpty, at = 0;
      if (tid < cap) {
        nb = load_i32(src + (size_t)cap * (d + 8) + 4 * tid);
        if (nb >= 0 && nb != forb) {
          for (at = slot_of(nb);; at = (at + 1) & (kTable - 1)) {
            const int prev = atomicCAS(&tab[at], kEmpty, nb);
            if (prev == kEmpty || prev == nb) break;
          }
        } else {
          nb = kEmpty;
        }
      }
      stage(row, src, cap * d);
      stage(row + L.off_s, src + cap * d, 8 * cap);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();  // the row, the table and the flag are in place

      if (tid == 0) {
        s_first = ef;
        s_nnew = 0;
      }
      head = head >= cap ? head - cap : head + R - cap;
      // the known test: every beam and ring id looks itself up in the table
      for (int i = tid; i < ef; i += kThreads) {
        const int pk = pkc[i];
        if (pk >= 0 && pk != kPad) mark(tab, hit, pk >> 1);
      }
      for (int i = tid; i < R; i += kThreads) {
        const int v = ring[i];
        if (v >= 0 && v != kPad) mark(tab, hit, v);
      }
      __syncthreads();  // the known marks are in place

      if (tid < cap) {
        const bool valid = nb != kEmpty;
        const bool fresh = valid && hit[at] == 0;
        int slot = head + tid;
        if (slot >= R) slot -= R;
        ring[slot] = fresh ? nb : kPad;
        t_valid += valid;
        t_new += fresh;
        if (fresh) {
          const int j = atomicAdd(&s_nnew, 1);
          nslot[j] = tid;
          npk[j] = 2 * nb;
        }
      }
      __syncthreads();  // the new entries are listed

      const int nnew = s_nnew;
      for (int i = tid; i < kTable; i += kThreads) {  // read in the last phase
        tab[i] = kEmpty;
        hit[i] = 0;
      }
      for (int j = warp; j < nnew; j += kThreads / 32) {
        const int s = nslot[j];
        const uint8_t* c = row + (size_t)s * d;
        const float mn = rscale[2 * s], delta = rscale[2 * s + 1];
        float acc = 0.f;
        if ((d & 3) == 0) {
          for (int k = 4 * lane; k < d; k += 128) {
            const uchar4 cc = *reinterpret_cast<const uchar4*>(c + k);
            const float4 qq = *reinterpret_cast<const float4*>(qs + k);
            const float x0 = __fadd_rn(__fmul_rn((float)cc.x, delta), mn);
            const float x1 = __fadd_rn(__fmul_rn((float)cc.y, delta), mn);
            const float x2 = __fadd_rn(__fmul_rn((float)cc.z, delta), mn);
            const float x3 = __fadd_rn(__fmul_rn((float)cc.w, delta), mn);
            const float e0 = qq.x - x0, e1 = qq.y - x1, e2 = qq.z - x2,
                        e3 = qq.w - x3;
            acc = __fadd_rn(acc, __fmul_rn(e0, e0));
            acc = __fadd_rn(acc, __fmul_rn(e1, e1));
            acc = __fadd_rn(acc, __fmul_rn(e2, e2));
            acc = __fadd_rn(acc, __fmul_rn(e3, e3));
          }
        } else {
          for (int k = lane; k < d; k += 32) {
            const float x = __fadd_rn(__fmul_rn((float)c[k], delta), mn);
            const float e = qs[k] - x;
            acc = __fadd_rn(acc, __fmul_rn(e, e));
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) nd2[j] = acc;
      }
      __syncthreads();  // the new distances are in place

      if (tid < nnew) {
        const float dj = nd2[tid];
        const int pj = npk[tid];
        int rank = 0;
        for (int k = 0; k < nnew; ++k) {
          const float dk = nd2[k];
          const int pk = npk[k];
          rank += key_less(dk, pk, dj, pj) || (dk == dj && pk == pj && k < tid);
        }
        sd2[rank] = dj;
        spk[rank] = pj;
      }
      __syncthreads();  // the new entries are sorted

      float* d2n = cur ? d2a : d2b;
      int* pkn = cur ? pka : pkb;
      for (int i = tid; i < ef; i += kThreads) {
        const float di = d2c[i];
        const int pi = pkc[i];
        int lo = 0, hi = nnew;  // new entries below (di, pi)
        while (lo < hi) {
          const int m = (lo + hi) >> 1;
          if (key_less(sd2[m], spk[m], di, pi)) lo = m + 1; else hi = m;
        }
        const int dest = i + lo;
        if (dest < ef) {
          d2n[dest] = di;
          pkn[dest] = pi;
          if (unexpanded(pi)) atomicMin(&s_first, dest);
        }
      }
      if (tid < nnew) {
        const float dj = sd2[tid];
        const int pj = spk[tid];
        int lo = 0, hi = ef;  // beam entries at or below (dj, pj)
        while (lo < hi) {
          const int m = (lo + hi) >> 1;
          if (!key_less(dj, pj, d2c[m], pkc[m])) lo = m + 1; else hi = m;
        }
        const int dest = tid + lo;
        if (dest < ef) {
          d2n[dest] = dj;
          pkn[dest] = pj;
          atomicMin(&s_first, dest);
        }
      }
      __syncthreads();  // the merged beam and its first unexpanded slot
      cur ^= 1;
      ++it;
    }

    const float* d2c = cur ? d2b : d2a;
    const int* pkc = cur ? pkb : pka;
    for (int i = tid; i < ef; i += kThreads) {
      const int pk = pkc[i];
      p.out_d2[(size_t)qi * ef + i] = d2c[i];
      p.out_ids[(size_t)qi * ef + i] = pk == kPad ? kPad : pk >> 1;
    }
    if (tid == 0) {
      atomicMax(&p.work[1], it);
      t_live += it;
    }
    __syncthreads();  // before the next query overwrites the state
  }

  if (p.tally) {
    if (tid == 0) atomicAdd(p.tally, t_live);
    if (tid < cap) {
      atomicAdd(p.tally + 1 + tid, t_valid);
      atomicAdd(p.tally + 1 + cap + tid, t_new);
    }
  }
}

}  // namespace

// The beam of every query (beam_packed.cu's note): packed u8 [n, cap*(d+12)],
// q f32 [B, d], entries f32 / i32 [B, k0], forbid i32 [B] or null; writes
// out_d2 f32 [B, ef], out_ids i32 [B, ef], work i32 [2] (zeroed here: the
// query counter, then the largest expansion count) and, when not null, adds
// into tally u64 [1 + 2*cap]. Launches on `stream`; returns a cudaError_t
// (0 = ok). Shapes past the kernel's limits return cudaErrorInvalidValue.
extern "C" int beam_packed_launch(const uint8_t* packed, long long n, int cap,
                                  int d, const float* q, const float* entry_d2,
                                  const int* entry_ids, int k0,
                                  const int* forbid, int B, int ef,
                                  int max_iters, int ring, float* out_d2,
                                  int* out_ids, int* work,
                                  unsigned long long* tally, void* stream) {
  if (cap < 1 || cap > kMaxCap || d < 1 || d > kMaxDim || ef < 1 ||
      ef > kMaxEf || ring < cap || ring > kMaxRing || B < 1 || k0 < 0 ||
      n < 1 || n >= (1LL << 30))
    return cudaErrorInvalidValue;
  const Layout L = layout(cap, d, ef, ring);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  if (L.bytes > 48 * 1024 &&
      (e = cudaFuncSetAttribute(beam_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                L.bytes)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, beam_kernel,
                                                         kThreads, L.bytes)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((e = cudaMemsetAsync(work, 0, 2 * sizeof(int), st)) != cudaSuccess)
    return e;
  Params p = {packed, n, cap, d, q, entry_d2, entry_ids, k0, forbid, B, ef,
              max_iters, ring, out_d2, out_ids, work, tally};
  const int grid = B < per_sm * sms ? B : per_sm * sms;
  beam_kernel<<<grid, kThreads, L.bytes, st>>>(p);
  return cudaGetLastError();
}

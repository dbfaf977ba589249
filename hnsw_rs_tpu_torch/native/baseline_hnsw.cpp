// A copy of hnsw_rs_tpu/native/baseline_hnsw.cpp (the JAX package's
// single-core C++ HNSW baseline), built for the PyTorch port by
// hnsw_rs_tpu_torch/native/__init__.py.
//
// Single-core sequential HNSW build baseline (C API, ctypes-loaded).
//
// Purpose: a MEASURED denominator for the "build throughput >= 50x the
// single-core reference rate" north star (BASELINE.md). Rust is not
// available in this image, so this is a clean, performance-conscious C++
// implementation of the same insert pipeline the reference runs
// single-threaded (hnsw/src/template.rs:388-445 with nb_threads=1):
// per-vector 8-bit scalar quantization (vectors/src/quant.rs:41-66),
// geometric level sampling (points/src/points.rs:148-160), greedy ef=1
// descent above the home level (inserter.rs:70-89), beam search with
// ef_cons + select_heuristic(m, extend_cands=true, keep_pruned=true)
// per layer (searcher.rs:23-153), bidirectional connect with
// select_simple pruning of overflowing neighbors (template.rs:196-251).
//
// This is written as a *favorable* baseline (flat adjacency, binary
// heaps, epoch-stamped visited marks, unrolled dequantized distance that
// g++ -O3 -march=native auto-vectorizes) so the measured rate errs on
// the high side; an honest x-factor divides by this, not by a gimped
// scalar port. NOT a translation of the reference's Rust (which chases
// IntMap/Arc<Mutex>/BTreeSet pointers and measures slower).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <random>
#include <chrono>
#include <algorithm>

namespace {

struct Quant {
    std::vector<uint8_t> codes;  // [n, d]
    std::vector<float> mn, delta;
    int64_t d = 0;
    void init(const float* vecs, int64_t n, int64_t dim) {
        d = dim;
        codes.resize(n * dim);
        mn.resize(n);
        delta.resize(n);
        for (int64_t i = 0; i < n; ++i) {
            const float* v = vecs + i * dim;
            float lo = v[0], hi = v[0];
            for (int64_t k = 1; k < dim; ++k) {
                lo = std::min(lo, v[k]);
                hi = std::max(hi, v[k]);
            }
            float de = (hi - lo) / 255.0f;
            if (de <= 0) de = 1.0f;
            mn[i] = lo;
            delta[i] = de;
            uint8_t* c = &codes[i * dim];
            for (int64_t k = 0; k < dim; ++k)
                c[k] = (uint8_t)std::floor((v[k] - lo) / de + 0.5f);
        }
    }
    // dequantize-on-the-fly squared L2 (the hot kernel; the reference's
    // distance_unrolled role). -O3 vectorizes the loop.
    inline float d2(uint32_t a, uint32_t b) const {
        const uint8_t* ca = &codes[(int64_t)a * d];
        const uint8_t* cb = &codes[(int64_t)b * d];
        const float ma = mn[a], mb = mn[b], da = delta[a], db = delta[b];
        float acc = 0.f;
        for (int64_t k = 0; k < d; ++k) {
            float diff = (ma + da * (float)ca[k]) - (mb + db * (float)cb[k]);
            acc += diff * diff;
        }
        return acc;
    }
};

struct DistId {
    float d;
    uint32_t id;
};
struct NearCmp {  // min-heap by (d, id)
    bool operator()(const DistId& a, const DistId& b) const {
        return a.d > b.d || (a.d == b.d && a.id > b.id);
    }
};
struct FarCmp {  // max-heap by (d, id)
    bool operator()(const DistId& a, const DistId& b) const {
        return a.d < b.d || (a.d == b.d && a.id < b.id);
    }
};

struct Baseline {
    Quant q;
    int m, ef_cons;
    int64_t n;
    // flat adjacency per layer: layer l row i at adj[l][i*cap(l)..]
    std::vector<std::vector<uint32_t>> adj;
    std::vector<std::vector<uint8_t>> deg;
    std::vector<int> levels;
    std::vector<uint32_t> visit_stamp;
    uint32_t epoch = 0;
    uint32_t ep = 0;
    int top = 0;

    int cap(int l) const { return l == 0 ? 2 * m : m; }

    void search_layer(uint32_t query, uint32_t entry, float entry_d, int l,
                      int ef, std::vector<DistId>& out) {
        ++epoch;
        const int c = cap(l);
        std::priority_queue<DistId, std::vector<DistId>, NearCmp> cands;
        std::priority_queue<DistId, std::vector<DistId>, FarCmp> sel;
        visit_stamp[entry] = epoch;
        cands.push({entry_d, entry});
        sel.push({entry_d, entry});
        while (!cands.empty()) {
            DistId cur = cands.top();
            if (cur.d > sel.top().d && (int)sel.size() >= ef) break;
            cands.pop();
            const uint32_t* nb = &adj[l][(int64_t)cur.id * c];
            const int dg = deg[l][cur.id];
            for (int j = 0; j < dg; ++j) {
                uint32_t e = nb[j];
                if (visit_stamp[e] == epoch) continue;
                visit_stamp[e] = epoch;
                float dd = q.d2(query, e);
                if ((int)sel.size() < ef || dd < sel.top().d) {
                    cands.push({dd, e});
                    sel.push({dd, e});
                    if ((int)sel.size() > ef) sel.pop();
                }
            }
        }
        out.resize(sel.size());
        for (int64_t i = (int64_t)sel.size() - 1; i >= 0; --i) {
            out[i] = sel.top();
            sel.pop();
        }
    }

    // Algorithm 4 with extend_cands=true, keep_pruned=true
    // (searcher.rs:109-153 semantics).
    void select_heuristic(uint32_t query, int l, std::vector<DistId>& pool,
                          int mm, std::vector<DistId>& out) {
        // extend: neighbors of every candidate join with true distances
        ++epoch;
        const int c = cap(l);
        size_t base = pool.size();
        for (auto& e : pool) visit_stamp[e.id] = epoch;
        for (size_t i = 0; i < base; ++i) {
            const uint32_t* nb = &adj[l][(int64_t)pool[i].id * c];
            const int dg = deg[l][pool[i].id];
            for (int j = 0; j < dg; ++j) {
                uint32_t e = nb[j];
                if (e == query || visit_stamp[e] == epoch) continue;
                visit_stamp[e] = epoch;
                pool.push_back({q.d2(query, e), e});
            }
        }
        std::sort(pool.begin(), pool.end(), [](const DistId& a, const DistId& b) {
            return a.d < b.d || (a.d == b.d && a.id < b.id);
        });
        out.clear();
        std::vector<DistId> rejected;
        for (auto& e : pool) {
            if ((int)out.size() >= mm) break;
            bool ok = true;
            for (auto& s : out) {
                if (q.d2(e.id, s.id) < e.d) { ok = false; break; }
            }
            if (ok) out.push_back(e);
            else rejected.push_back(e);
        }
        for (auto& e : rejected) {  // keep_pruned backfill
            if ((int)out.size() >= mm) break;
            out.push_back(e);
        }
    }

    void connect(uint32_t node, int l, const std::vector<DistId>& nbrs) {
        const int c = cap(l);
        uint32_t* row = &adj[l][(int64_t)node * c];
        int dg = 0;
        for (auto& e : nbrs) {
            if (dg >= c) break;
            row[dg++] = e.id;
        }
        deg[l][node] = (uint8_t)dg;
        // reverse edges; prune overflowing targets with select_simple
        // (keep the cap nearest, template.rs:209-238)
        for (auto& e : nbrs) {
            uint32_t t = e.id;
            uint32_t* trow = &adj[l][(int64_t)t * c];
            int tdg = deg[l][t];
            if (tdg < c) {
                trow[tdg] = node;
                deg[l][t] = (uint8_t)(tdg + 1);
            } else {
                // find the farthest incumbent; replace if new edge is nearer
                float worst = -1.f;
                int wj = -1;
                for (int j = 0; j < tdg; ++j) {
                    float dd = q.d2(t, trow[j]);
                    if (dd > worst) { worst = dd; wj = j; }
                }
                if (e.d < worst && wj >= 0) trow[wj] = node;
            }
        }
    }

    void insert(uint32_t node) {
        int lvl = levels[node];
        uint32_t cur = ep;
        float curd = q.d2(node, cur);
        for (int l = top; l > lvl; --l) {  // greedy descent (ef=1)
            bool moved = true;
            const int c = cap(l);
            while (moved) {
                moved = false;
                const uint32_t* nb = &adj[l][(int64_t)cur * c];
                const int dg = deg[l][cur];
                for (int j = 0; j < dg; ++j) {
                    float dd = q.d2(node, nb[j]);
                    if (dd < curd) { curd = dd; cur = nb[j]; moved = true; }
                }
            }
        }
        std::vector<DistId> beam, sel;
        for (int l = std::min(top, lvl); l >= 0; --l) {
            search_layer(node, cur, curd, l, ef_cons, beam);
            std::vector<DistId> pool(beam);
            select_heuristic(node, l, pool, m, sel);
            connect(node, l, sel);
            if (!beam.empty()) { cur = beam[0].id; curd = beam[0].d; }
        }
        if (lvl > top) { top = lvl; ep = node; }
    }
};

}  // namespace

extern "C" {

// Builds the index single-threaded; returns elapsed seconds for the
// insert loop (quantization + level sampling excluded, matching how the
// TPU builder's rate is measured from store-ready state). out_rate_vps
// receives vectors/second. Returns 0 on success.
int hnsw_baseline_build(const float* vecs, int64_t n, int64_t d,
                        int m, int ef_cons, uint64_t seed,
                        double* out_seconds, double* out_rate_vps) {
    if (n <= 0 || d <= 0 || m <= 0) return -1;
    Baseline B;
    B.m = m;
    B.ef_cons = ef_cons > 0 ? ef_cons : 2 * m;
    B.n = n;
    B.q.init(vecs, n, d);
    // geometric levels, ml = 1/ln(m) (points/src/points.rs:148-160)
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    double ml = 1.0 / std::log((double)m);
    B.levels.resize(n);
    int top = 0;
    for (int64_t i = 0; i < n; ++i) {
        double u = uni(rng);
        while (u <= 0.0 || u >= 1.0) u = uni(rng);
        int lv = (int)std::floor(-std::log(u) * ml);
        B.levels[i] = lv;
        top = std::max(top, lv);
    }
    B.adj.resize(top + 1);
    B.deg.resize(top + 1);
    for (int l = 0; l <= top; ++l) {
        B.adj[l].assign((int64_t)n * B.cap(l), 0);
        B.deg[l].assign(n, 0);
    }
    B.visit_stamp.assign(n, 0);
    // first point of the max level is the entry point
    B.top = 0;
    B.ep = 0;
    B.levels[0] = top;  // pin node 0 to the top so the stack exists from
                        // the start (the reference re-sorts EPs as levels
                        // appear; this is rate-neutral)
    B.top = top;
    auto t0 = std::chrono::steady_clock::now();
    for (int64_t i = 1; i < n; ++i) B.insert((uint32_t)i);
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count();
    if (out_seconds) *out_seconds = secs;
    if (out_rate_vps) *out_rate_vps = secs > 0 ? (double)(n - 1) / secs : 0.0;
    return 0;
}

// Single-thread query throughput of the same index (README's ~300 req/s
// role): builds, then times nq queries one at a time at the given ef.
int hnsw_baseline_query_rate(const float* vecs, int64_t n, int64_t d,
                             const float* queries, int64_t nq,
                             int m, int ef_cons, int ef, int k,
                             uint64_t seed, double* out_qps,
                             int32_t* out_ids /* [nq*k] or NULL */) {
    if (n <= 0 || nq <= 0) return -1;
    Baseline B;
    B.m = m;
    B.ef_cons = ef_cons > 0 ? ef_cons : 2 * m;
    B.n = n;
    // store queries behind the points so d2() covers them
    std::vector<float> all((n + nq) * d);
    std::memcpy(all.data(), vecs, sizeof(float) * n * d);
    std::memcpy(all.data() + n * d, queries, sizeof(float) * nq * d);
    B.q.init(all.data(), n + nq, d);
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    double ml = 1.0 / std::log((double)m);
    B.levels.resize(n);
    int top = 0;
    for (int64_t i = 0; i < n; ++i) {
        double u = uni(rng);
        while (u <= 0.0 || u >= 1.0) u = uni(rng);
        B.levels[i] = (int)std::floor(-std::log(u) * ml);
        top = std::max(top, B.levels[i]);
    }
    B.adj.resize(top + 1);
    B.deg.resize(top + 1);
    for (int l = 0; l <= top; ++l) {
        B.adj[l].assign((int64_t)n * B.cap(l), 0);
        B.deg[l].assign(n, 0);
    }
    B.visit_stamp.assign(n + nq, 0);
    B.levels[0] = top;
    B.top = top;
    B.ep = 0;
    for (int64_t i = 1; i < n; ++i) B.insert((uint32_t)i);
    std::vector<DistId> beam;
    auto t0 = std::chrono::steady_clock::now();
    for (int64_t qi = 0; qi < nq; ++qi) {
        uint32_t query = (uint32_t)(n + qi);
        uint32_t cur = B.ep;
        float curd = B.q.d2(query, cur);
        for (int l = B.top; l > 0; --l) {
            bool moved = true;
            const int c = B.cap(l);
            while (moved) {
                moved = false;
                const uint32_t* nb = &B.adj[l][(int64_t)cur * c];
                for (int j = 0; j < B.deg[l][cur]; ++j) {
                    float dd = B.q.d2(query, nb[j]);
                    if (dd < curd) { curd = dd; cur = nb[j]; moved = true; }
                }
            }
        }
        B.search_layer(query, cur, curd, 0, ef, beam);
        if (out_ids) {
            for (int j = 0; j < k; ++j)
                out_ids[qi * k + j] =
                    j < (int)beam.size() ? (int32_t)beam[j].id : -1;
        }
    }
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count();
    if (out_qps) *out_qps = secs > 0 ? (double)nq / secs : 0.0;
    return 0;
}

}  // extern "C"

// A copy of hnsw_rs_tpu/native/fastio.cpp (the JAX package's native host
// runtime), built for the PyTorch port by hnsw_rs_tpu_torch/native/__init__.py.
//
// Native host-side IO kernels for hnsw_rs_tpu.
//
// The reference implements its data loaders in native (Rust) code
// (hnsw/src/helpers/glove.rs:14-71 — text embedding parsing); this is the
// C++ equivalent for the TPU framework's host runtime: a memory-mapped,
// single-pass GloVe text parser (~30-50x the pure-Python loader), plus a
// block codec used by the paged on-disk store (the BlockPoints analogue,
// points/src/points/block_points.rs).
//
// Exposed with C linkage and driven from Python via ctypes (no pybind11
// dependency). Build: see native/__init__.py (g++ -O3 -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Fast float parse over a known-clean decimal format ("-12.345e-6").
// Falls back to strtof for anything exotic.
inline float parse_float(const char*& p, const char* end) {
    const char* start = p;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = *p == '-'; ++p; }
    double val = 0.0;
    while (p < end && *p >= '0' && *p <= '9') { val = val * 10.0 + (*p - '0'); ++p; }
    if (p < end && *p == '.') {
        ++p;
        double frac = 0.0, scale = 1.0;
        while (p < end && *p >= '0' && *p <= '9') {
            frac = frac * 10.0 + (*p - '0');
            scale *= 10.0;
            ++p;
        }
        val += frac / scale;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        // rare path: defer to strtof for full correctness. Copy the token
        // into a NUL-terminated buffer first: the mmap is not
        // NUL-terminated, and a number ending exactly at EOF of a
        // page-multiple-sized file would let strtof read past the mapping.
        char buf[64];
        size_t i = 0;
        for (const char* c = start; c < end && i < sizeof(buf) - 1; ++c) {
            if (*c == ' ' || *c == '\t' || *c == '\n' || *c == '\r') break;
            buf[i++] = *c;
        }
        buf[i] = '\0';
        char* q = nullptr;
        float f = strtof(buf, &q);
        p = start + (q - buf);
        return f;
    }
    return neg ? -(float)val : (float)val;
}

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
    Mapped m;
    m.fd = open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (fstat(m.fd, &st) != 0 || st.st_size == 0) { close(m.fd); m.fd = -1; return m; }
    void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) { close(m.fd); m.fd = -1; return m; }
    m.data = (const char*)p;
    m.size = st.st_size;
    return m;
}

void unmap(Mapped& m) {
    if (m.data) munmap((void*)m.data, m.size);
    if (m.fd >= 0) close(m.fd);
}

}  // namespace

extern "C" {

// First pass: count rows and infer the vector dimension.
// Returns 0 on success.
int glove_shape(const char* path, int64_t limit, int64_t* n_out, int64_t* d_out) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    const char* p = m.data;
    const char* end = m.data + m.size;
    // dimension = tokens on the first line minus the word
    int64_t d = 0;
    {
        const char* q = p;
        bool in_tok = false;
        int64_t toks = 0;
        while (q < end && *q != '\n') {
            if (*q == ' ') in_tok = false;
            else if (!in_tok) { in_tok = true; ++toks; }
            ++q;
        }
        d = toks - 1;
    }
    int64_t n = 0;
    for (const char* q = p; q < end; ++q) {
        if (*q == '\n') {
            ++n;
            if (limit > 0 && n >= limit) break;
        }
    }
    if (m.size > 0 && m.data[m.size - 1] != '\n' && (limit <= 0 || n < limit)) ++n;
    unmap(m);
    *n_out = n;
    *d_out = d;
    return 0;
}

// Second pass: parse up to n rows of "word v1 ... vd" into out[n*d] and
// fixed-width word slots words[n*word_cap] (NUL padded/truncated).
// Returns number of rows parsed, or -1 on IO error, -2 on ragged row.
int64_t glove_parse(const char* path, int64_t n, int64_t d, float* out,
                    char* words, int64_t word_cap) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    const char* p = m.data;
    const char* end = m.data + m.size;
    int64_t row = 0;
    while (p < end && row < n) {
        // word token
        const char* w = p;
        while (p < end && *p != ' ' && *p != '\n') ++p;
        if (words) {
            int64_t len = p - w;
            if (len > word_cap - 1) len = word_cap - 1;
            memcpy(words + row * word_cap, w, len);
            memset(words + row * word_cap + len, 0, word_cap - len);
        }
        // d floats
        int64_t col = 0;
        float* dst = out + row * d;
        while (p < end && *p != '\n') {
            if (*p == ' ') { ++p; continue; }
            if (col >= d) { unmap(m); return -2; }
            dst[col++] = parse_float(p, end);
        }
        if (col != d) { unmap(m); return -2; }
        if (p < end) ++p;  // consume newline
        ++row;
    }
    unmap(m);
    return row;
}

// Paged-store block IO (the BlockPoints layout analogue,
// points/src/points/block_points.rs: fixed blocks of points, id derived
// arithmetically from block index): read `count` point records of
// `point_size` bytes starting at byte `offset` without loading the file.
int64_t pread_block(const char* path, int64_t offset, int64_t nbytes, uint8_t* out) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    int64_t got = pread(fd, out, nbytes, offset);
    close(fd);
    return got;
}

// Cold-tier packed-row assembly for the hybrid paged server
// (models/paged.py HybridPagedHNSW): for each requested node, gather its
// adjacency row from the raw int32 memmap file and its neighbors'
// records from the block file, and emit the serving pack_layer byte
// layout `codes u8[cap*d] | scales f32-LE[cap*2] | ids i32[cap*4]`.
// The block record is `level u8 | min f32 BE | delta f32 BE | codes
// u8[d]` (points/src/point.rs:46-76 codec), so min/delta are byte-
// swapped to the native little-endian bitcast pack_layer expects. Both
// files are mmap'd once per call; the OS page cache is the cold-row LRU.
// Returns k on success, negative on error.
int64_t assemble_packed_rows(const char* adj_path, int64_t n, int64_t cap,
                             const char* blocks_path, int64_t d,
                             int64_t max_per_block, const int64_t* ids,
                             int64_t k, uint8_t* out) {
    Mapped adj_m = map_file(adj_path);
    if (!adj_m.ok()) return -1;
    Mapped blk_m = map_file(blocks_path);
    if (!blk_m.ok()) { unmap(adj_m); return -2; }
    const int64_t ps = 9 + d;                    // record size
    const int64_t file_header = 16, block_header = 6;
    const int64_t block_bytes = block_header + max_per_block * ps;
    const int64_t wrow = cap * (d + 12);
    const int32_t* adj = (const int32_t*)adj_m.data;
    const uint8_t* blk = (const uint8_t*)blk_m.data;
    for (int64_t i = 0; i < k; i++) {
        int64_t id = ids[i];
        if (id < 0) id = 0;
        if (id >= n) id = n - 1;
        const int32_t* row = adj + id * cap;
        uint8_t* oc = out + i * wrow;            // codes region
        uint8_t* os = oc + cap * d;              // scales region
        uint8_t* oi = os + cap * 8;              // ids region
        for (int64_t j = 0; j < cap; j++) {
            int32_t nbr = row[j];
            int64_t safe = nbr < 0 ? 0 : nbr;
            if (safe >= n) safe = n - 1;
            const uint8_t* rec = blk + file_header
                + (safe / max_per_block) * block_bytes + block_header
                + (safe % max_per_block) * ps;
            memcpy(oc + j * d, rec + 9, d);
            // BE -> LE f32 byte swap for (min, delta)
            uint8_t* s = os + j * 8;
            s[0] = rec[4]; s[1] = rec[3]; s[2] = rec[2]; s[3] = rec[1];
            s[4] = rec[8]; s[5] = rec[7]; s[6] = rec[6]; s[7] = rec[5];
            memcpy(oi + j * 4, &nbr, 4);
        }
    }
    unmap(adj_m);
    unmap(blk_m);
    return k;
}

// Fused single-pass per-vector 8-bit scalar quantization (the hot host
// step of bulk builds: numpy's min/max/sub/div/floor pipeline makes ~6
// full-size passes + temps over the f32 input; this makes 2 cache-hot
// passes per row and writes codes+scales directly). Arithmetic is
// bit-identical to ops.quant.quantize_np — every op is a single IEEE-754
// f32 min/max/sub/div/add/floor in the same order (no FMA contraction
// applies: there is no mul+add pair), so codes match the numpy and the
// XLA:CPU device paths exactly (pinned by tests/test_native.py).
// Mirrors the role of QuantVec::new (vectors/src/quant.rs:41-66).
int64_t quantize_rows(const float* x, int64_t n, int64_t d,
                      uint8_t* codes, float* scales) {
    if (n <= 0 || d <= 0) return -1;
    for (int64_t i = 0; i < n; i++) {
        const float* row = x + i * d;
        float mn = row[0], mx = row[0];
        for (int64_t j = 1; j < d; j++) {
            float v = row[j];
            if (v < mn) mn = v;
            if (v > mx) mx = v;
        }
        float delta = (mx - mn) / 255.0f;
        float safe = delta > 0.0f ? delta : 1.0f;
        float inv_used = safe;  // keep true division (x-mn)/safe: a
        // reciprocal-multiply would round differently from numpy
        uint8_t* oc = codes + i * d;
        if (delta > 0.0f) {
            for (int64_t j = 0; j < d; j++) {
                float t = (row[j] - mn) / inv_used;
                float f = std::floor(t + 0.5f);
                if (f < 0.0f) f = 0.0f;
                if (f > 255.0f) f = 255.0f;
                oc[j] = (uint8_t)f;
            }
        } else {
            for (int64_t j = 0; j < d; j++) oc[j] = 0;
        }
        scales[i * 2] = mn;
        scales[i * 2 + 1] = delta;
    }
    return n;
}

}  // extern "C"

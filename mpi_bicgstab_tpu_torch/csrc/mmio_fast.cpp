// Fast Matrix Market coordinate-body parser.
//
// The reference's documented IO hotspot is every rank fscanf-ing the
// whole .mtx twice (matrix.c:315-393: 23.5M fscanf calls x 2 x nprocs
// for Transport). This native parser replaces the per-token scanf with
// a single-pass, multi-threaded chunked scan over the body, run once on
// the host (a copy of the JAX package's io/csrc/mmio_fast.cpp).
//
// Exposed as a plain C ABI, loaded with ctypes (io/native.py):
//   mmio_parse_body(buf, len, nnz, per_row, rows, cols, vals, nthreads)
//     buf/len:   the body bytes (after banner + size line)
//     per_row:   2 (pattern) or 3 (real/integer)
//     rows/cols: int64[nnz] out; vals: double[nnz] out (1.0 if pattern)
//     returns parsed entry count (== nnz on success, < 0 on error)
//
// Build (utils/host_build.py, into build/host/<hash>/):
//   g++ -O3 -march=native -shared -fPIC -o libmmio_fast.so mmio_fast.cpp -lpthread
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <thread>
#include <vector>
#include <atomic>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        ++p;
    return p;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
    p = skip_ws(p, end);
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    int64_t v = 0;
    const char* start = p;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
    if (p == start) return nullptr;
    *out = neg ? -v : v;
    return p;
}

// strtod-compatible-enough float parse (handles scientific notation);
// falls back to strtod for unusual forms.
inline const char* parse_f64(const char* p, const char* end, double* out) {
    p = skip_ws(p, end);
    char* q = nullptr;
    // strtod needs NUL-termination safety: the caller guarantees the
    // buffer has a readable sentinel past `end` (we parse a copy).
    *out = std::strtod(p, &q);
    if (q == p) return nullptr;
    return q;
}

struct ChunkResult {
    int64_t count = 0;
    int error = 0;
};

void parse_chunk(const char* body, const char* end,
                 const char* chunk_begin, const char* chunk_end,
                 int per_row, int64_t base_index,
                 int64_t* rows, int64_t* cols, double* vals,
                 ChunkResult* res) {
    // Align to the start of a line: skip the partial line at the head
    // (owned by the previous chunk) unless we start at the body start.
    const char* p = chunk_begin;
    if (p != body) {
        while (p < chunk_end && *p != '\n') ++p;
        if (p < chunk_end) ++p;
    }
    int64_t i = base_index;
    while (p < chunk_end) {
        p = skip_ws(p, end);
        if (p >= chunk_end) break;
        if (*p == '%') {  // comment line inside body (legal)
            while (p < end && *p != '\n') ++p;
            continue;
        }
        int64_t r, c;
        const char* q = parse_i64(p, end, &r);
        if (!q) { res->error = 1; return; }
        q = parse_i64(q, end, &c);
        if (!q) { res->error = 2; return; }
        double v = 1.0;
        if (per_row == 3) {
            q = parse_f64(q, end, &v);
            if (!q) { res->error = 3; return; }
        }
        rows[i] = r - 1;  // 1-based -> 0-based (reference matrix.c:76-77)
        cols[i] = c - 1;
        vals[i] = v;
        ++i;
        p = q;
    }
    res->count = i - base_index;
}

// Pass 1: count complete lines beginning inside [chunk_begin, chunk_end)
int64_t count_chunk(const char* body, const char* chunk_begin,
                    const char* chunk_end, const char* end) {
    const char* p = chunk_begin;
    if (p != body) {
        while (p < chunk_end && *p != '\n') ++p;
        if (p < chunk_end) ++p;
    }
    int64_t cnt = 0;
    while (p < chunk_end) {
        p = skip_ws(p, end);
        if (p >= chunk_end) break;
        if (*p == '%') {
            while (p < end && *p != '\n') ++p;
            continue;
        }
        ++cnt;
        while (p < end && *p != '\n') ++p;
    }
    return cnt;
}

}  // namespace

extern "C" {

int64_t mmio_parse_body(const char* buf, int64_t len, int64_t nnz,
                        int per_row, int64_t* rows, int64_t* cols,
                        double* vals, int nthreads) {
    if (per_row != 2 && per_row != 3) return -10;
    const char* end = buf + len;
    if (nthreads <= 0) {
        nthreads = (int)std::thread::hardware_concurrency();
        if (nthreads <= 0) nthreads = 1;
    }
    if (len < (1 << 20)) nthreads = 1;
    std::vector<const char*> bounds(nthreads + 1);
    for (int t = 0; t <= nthreads; ++t)
        bounds[t] = buf + (len * t) / nthreads;

    // pass 1: per-chunk entry counts -> output offsets
    std::vector<int64_t> counts(nthreads, 0);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < nthreads; ++t)
            th.emplace_back([&, t] {
                counts[t] = count_chunk(buf, bounds[t], bounds[t + 1], end);
            });
        for (auto& x : th) x.join();
    }
    std::vector<int64_t> offs(nthreads + 1, 0);
    for (int t = 0; t < nthreads; ++t) offs[t + 1] = offs[t] + counts[t];
    if (offs[nthreads] != nnz) return -(int64_t)offs[nthreads] - 100;

    // pass 2: parse
    std::vector<ChunkResult> res(nthreads);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < nthreads; ++t)
            th.emplace_back([&, t] {
                parse_chunk(buf, end, bounds[t], bounds[t + 1], per_row,
                            offs[t], rows, cols, vals, &res[t]);
            });
        for (auto& x : th) x.join();
    }
    int64_t total = 0;
    for (int t = 0; t < nthreads; ++t) {
        if (res[t].error) return -res[t].error;
        total += res[t].count;
    }
    return total;
}

}  // extern "C"

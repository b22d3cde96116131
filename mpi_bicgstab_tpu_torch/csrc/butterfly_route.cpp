// Butterfly route assignment on the host (counterpart of
// mpi_bicgstab_tpu/ops/csrc/butterfly_route.cpp, the same code, so that the
// same seed gives the same routes in both packages): the hot loops of
// ops/butterfly._assign_routes and of build_butterfly's slab colouring.
// One sequential pass over the elements: an element claims its slots at
// once and, on a conflict, retries on the spot with a fresh random
// option (a splitmix64 generator seeded from `seed`, so the result is
// deterministic).
//
// Constraint families (see ops/butterfly._assign_routes): dest slot
// (d, m_lo) strict; u1 slot (a, b) strict; two gather-row
// lane-injectivity families, rider-tolerant on equal value.
//
// Built with g++ -O3 -march=native -shared -fPIC at first use
// (ops/native_route.py) and called through ctypes:
//   bfly_assign(E, d[], u_col[], m_hi[], q[], src_lane[],
//               win_a[], n_opts[], max_k, Ts, G, P, Td,
//               seed, tries, a_sel[], m_sel[]) -> assigned count
//   bfly_color(NE, rows[], grp[], lane[], sub[], n_pad, NR, W3,
//              seed, tries, w_sel[]) -> assigned count
// Both return -1 when their claim tables cannot be allocated.
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {
inline uint64_t splitmix64(uint64_t &s) {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}
}  // namespace

extern "C" int64_t bfly_assign(
    int64_t E, const int64_t *d, const int64_t *u_col,
    const int64_t *m_hi, const int64_t *q, const int64_t *src_lane,
    const int64_t *win_a, const int64_t *n_opts, int64_t max_k,
    int64_t Ts, int64_t G, int64_t P, int64_t Td,
    uint64_t seed, int64_t tries, int64_t *a_sel, int64_t *m_sel) {
    const int64_t B = 1024, LANES = 128;
    const int64_t PB = P * B, TB = Td * B;
    uint8_t *taken_d = (uint8_t *)calloc(TB, 1);
    uint8_t *taken_a = (uint8_t *)calloc(PB, 1);
    int32_t *val_l1 = (int32_t *)calloc(PB, sizeof(int32_t));
    int32_t *val_l2 = (int32_t *)calloc(PB, sizeof(int32_t));
    if (!taken_d || !taken_a || !val_l1 || !val_l2) {
        free(taken_d); free(taken_a); free(val_l1); free(val_l2);
        return -1;
    }
    int64_t assigned = 0;
    uint64_t st = seed * 0x2545F4914F6CDD1DULL + 0x1234567ULL;
    for (int64_t e = 0; e < E; ++e) {
        const int64_t s = u_col[e] / B;
        const int64_t mh = m_hi[e];
        const int64_t de = d[e];
        const int64_t nopt = n_opts[s];
        a_sel[e] = -1;
        m_sel[e] = -1;
        for (int64_t t = 0; t < tries; ++t) {
            const uint64_t r1 = splitmix64(st);
            const int64_t a = win_a[s * max_k + (int64_t)(r1 % (uint64_t)nopt)];
            const int64_t a_hi = a / B;
            int64_t rem = (a_hi - B * mh) % G;
            if (rem < 0) rem += G;
            const int64_t base = B * mh + rem;
            const int64_t n_t = (B * mh + B - 1 - base) / G + 1;
            const uint64_t r2 = splitmix64(st);
            const int64_t m = base + G * (int64_t)(r2 % (uint64_t)n_t);
            const int64_t b = (m - a_hi) / G;
            const int64_t kd = de * B + (m % B);
            const int64_t ka = a * B + b;
            const int64_t kl1 = a * B + (b / LANES) * LANES + src_lane[e];
            const int32_t vl1 = (int32_t)u_col[e] + 1;
            const int64_t kl2 = m * B + (q[e] / LANES) * LANES + (a % LANES);
            const int32_t vl2 = (int32_t)(a % B) + 1;
            if (taken_d[kd] || taken_a[ka]) continue;
            if (val_l1[kl1] != 0 && val_l1[kl1] != vl1) continue;
            if (val_l2[kl2] != 0 && val_l2[kl2] != vl2) continue;
            taken_d[kd] = 1;
            taken_a[ka] = 1;
            val_l1[kl1] = vl1;
            val_l2[kl2] = vl2;
            a_sel[e] = a;
            m_sel[e] = m;
            ++assigned;
            break;
        }
    }
    free(taken_d); free(taken_a); free(val_l1); free(val_l2);
    return assigned;
}

// K3 slab coloring (the second retry loop in build_butterfly): place
// each (row, lane, sublane-value) entry into one of W3 slabs such that
// a row appears once per slab and the (group, slab, lane) sublane
// table stays single-valued (riders on equal value pass).
extern "C" int64_t bfly_color(
    int64_t NE, const int64_t *rows, const int64_t *grp,
    const int64_t *lane, const int64_t *sub,
    int64_t n_pad, int64_t NR, int64_t W3,
    uint64_t seed, int64_t tries, int64_t *w_sel) {
    const int64_t LANES = 128;
    uint8_t *taken_row = (uint8_t *)calloc(n_pad * W3, 1);
    int16_t *val_gl = (int16_t *)calloc(NR * W3 * LANES, sizeof(int16_t));
    if (!taken_row || !val_gl) {
        free(taken_row); free(val_gl);
        return -1;
    }
    int64_t assigned = 0;
    uint64_t st = seed * 0x9E3779B97F4A7C15ULL + 0xabcdefULL;
    for (int64_t e = 0; e < NE; ++e) {
        w_sel[e] = -1;
        const int16_t v = (int16_t)sub[e] + 1;
        for (int64_t t = 0; t < tries; ++t) {
            const uint64_t r = splitmix64(st);
            const int64_t w = (int64_t)(r % (uint64_t)W3);
            const int64_t krow = rows[e] * W3 + w;
            const int64_t kgl = (grp[e] * W3 + w) * LANES + lane[e];
            if (taken_row[krow]) continue;
            if (val_gl[kgl] != 0 && val_gl[kgl] != v) continue;
            taken_row[krow] = 1;
            val_gl[kgl] = v;
            w_sel[e] = w;
            ++assigned;
            break;
        }
    }
    free(taken_row); free(val_gl);
    return assigned;
}

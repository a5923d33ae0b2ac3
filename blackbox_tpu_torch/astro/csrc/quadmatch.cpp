// quadmatch.cpp — blind astrometric solve by geometric quad hashing.
//
// Native (host-side C++) replacement for Astrometry.net's solve-field,
// which the reference pipeline shells out to through zogy (reference
// blackbox.py A-* keywords; SURVEY.md §2.4 row "Astrometry.net").  The
// algorithm is the classic Lang et al. (2010) scheme:
//
//   * INDEX: from a reference star catalog, form "quads" of 4 stars
//     (A,B the most-separated pair; C,D inside the circle of diameter
//     AB) and store the similarity-invariant 4-vector hash code — the
//     positions of C and D in the frame that maps A->(0,0), B->(1,1) —
//     sorted by first component for range lookup.
//   * SOLVE: form the same codes from the brightest image detections
//     (both parities: the pixel grid may be mirrored w.r.t. the sky),
//     look up near-matching index codes, fit a 4-point affine
//     pixel -> tangent-plane transform for each candidate, and verify
//     it by projecting the whole reference catalog into the image and
//     counting detections that line up.  Best verified candidate wins.
//
// Everything is double precision on host: a solve touches a few
// thousand stars — no device work (SURVEY.md §2.4 plans this component
// as "host-side C++ quad-hash match against Gaia index").
//
// C ABI only; driven from Python via ctypes (astro/blindsolve.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

const double D2R = M_PI / 180.0;

struct V3 { double x, y, z; };

V3 radec2xyz(double ra_deg, double dec_deg) {
    const double r = ra_deg * D2R, d = dec_deg * D2R;
    return {std::cos(d) * std::cos(r), std::cos(d) * std::sin(r),
            std::sin(d)};
}

V3 normalize(const V3& v) {
    const double n = std::sqrt(v.x * v.x + v.y * v.y + v.z * v.z);
    return {v.x / n, v.y / n, v.z / n};
}

// Gnomonic projection of unit vector p onto the tangent plane at unit
// vector t; basis xi = local East, eta = local North.  Returns false
// for points on the far hemisphere.  xi/eta in radians.
bool gnomonic(const V3& p, const V3& t, double* xi, double* eta) {
    const double dot = p.x * t.x + p.y * t.y + p.z * t.z;
    if (dot <= 0.1) return false;
    double ex = -t.y, ey = t.x;                 // z-hat cross t
    const double en = std::sqrt(ex * ex + ey * ey);
    if (en < 1e-12) { ex = 1.0; ey = 0.0; }     // tangent at a pole
    else            { ex /= en; ey /= en; }
    // north = t cross east
    const double nx = -t.z * ey, ny = t.z * ex,
                 nz = t.x * ey - t.y * ex;
    *xi = (p.x * ex + p.y * ey) / dot;
    *eta = (p.x * nx + p.y * ny + p.z * nz) / dot;
    return true;
}

// Canonical quad code from 4 planar points.  Maps A->(0,0), B->(1,1)
// (complex w = (z-A)/(B-A)*(1+i)) and stores (Cx,Cy,Dx,Dy) with the two
// symmetry conventions: Cx+Dx <= 1 (choice of A vs B; swapping A,B maps
// w -> (1+i)-w) and C lexicographically <= D.  perm[k] records which
// input point (0..3 = A,B,C,D as passed) landed in canonical slot k.
bool make_code(const double px[4], const double py[4],
               double code[4], int perm[4]) {
    const double vx = px[1] - px[0], vy = py[1] - py[0];
    const double n2 = vx * vx + vy * vy;
    if (n2 < 1e-24) return false;
    double w[2][2];
    for (int k = 0; k < 2; ++k) {
        const double rx = px[2 + k] - px[0], ry = py[2 + k] - py[0];
        const double qx = (rx * vx + ry * vy) / n2;
        const double qy = (ry * vx - rx * vy) / n2;
        w[k][0] = qx - qy;                      // times (1+i)
        w[k][1] = qx + qy;
    }
    // C and D must lie within the circle of diameter AB, i.e. radius
    // sqrt(1/2) around (1/2, 1/2) in code space (small margin for noise)
    for (int k = 0; k < 2; ++k) {
        const double dx = w[k][0] - 0.5, dy = w[k][1] - 0.5;
        if (dx * dx + dy * dy > 0.52) return false;
    }
    perm[0] = 0; perm[1] = 1; perm[2] = 2; perm[3] = 3;
    if (w[0][0] + w[1][0] > 1.0) {
        for (int k = 0; k < 2; ++k) {
            w[k][0] = 1.0 - w[k][0];
            w[k][1] = 1.0 - w[k][1];
        }
        std::swap(perm[0], perm[1]);
    }
    if (w[0][0] > w[1][0] ||
        (w[0][0] == w[1][0] && w[0][1] > w[1][1])) {
        std::swap(w[0][0], w[1][0]);
        std::swap(w[0][1], w[1][1]);
        std::swap(perm[2], perm[3]);
    }
    code[0] = w[0][0]; code[1] = w[0][1];
    code[2] = w[1][0]; code[3] = w[1][1];
    return true;
}

// spatial hash of 3-D points into cubic cells (for neighbour search)
struct CellHash {
    double cell;
    std::unordered_map<int64_t, std::vector<int32_t>> map;

    explicit CellHash(double cell_size) : cell(cell_size) {}

    static int64_t key3(int64_t i, int64_t j, int64_t k) {
        return ((i + (1 << 20)) << 42) | ((j + (1 << 20)) << 21)
               | (k + (1 << 20));
    }
    int64_t key(const V3& v) const {
        return key3((int64_t)std::floor(v.x / cell),
                    (int64_t)std::floor(v.y / cell),
                    (int64_t)std::floor(v.z / cell));
    }
    void insert(const V3& v, int32_t idx) { map[key(v)].push_back(idx); }

    template <class F>
    void around(const V3& v, F&& fn) const {
        const int64_t ci = (int64_t)std::floor(v.x / cell);
        const int64_t cj = (int64_t)std::floor(v.y / cell);
        const int64_t ck = (int64_t)std::floor(v.z / cell);
        for (int64_t di = -1; di <= 1; ++di)
            for (int64_t dj = -1; dj <= 1; ++dj)
                for (int64_t dk = -1; dk <= 1; ++dk) {
                    auto it = map.find(key3(ci + di, cj + dj, ck + dk));
                    if (it == map.end()) continue;
                    for (int32_t idx : it->second) fn(idx);
                }
    }
};

uint64_t quad_key(int32_t a, int32_t b, int32_t c, int32_t d) {
    int32_t v[4] = {a, b, c, d};
    std::sort(v, v + 4);
    uint64_t h = 1469598103934665603ull;
    for (int k = 0; k < 4; ++k) {
        h ^= (uint64_t)(uint32_t)v[k];
        h *= 1099511628211ull;
    }
    return h;
}

// 3x3 symmetric solve (normal equations for the 4-point affine fit)
bool solve3(const double M[3][3], const double r[3], double out[3]) {
    double a[3][4];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) a[i][j] = M[i][j];
        a[i][3] = r[i];
    }
    for (int col = 0; col < 3; ++col) {
        int piv = col;
        for (int i = col + 1; i < 3; ++i)
            if (std::fabs(a[i][col]) > std::fabs(a[piv][col])) piv = i;
        if (std::fabs(a[piv][col]) < 1e-18) return false;
        if (piv != col)
            for (int j = 0; j < 4; ++j) std::swap(a[piv][j], a[col][j]);
        for (int i = 0; i < 3; ++i) {
            if (i == col) continue;
            const double f = a[i][col] / a[col][col];
            for (int j = col; j < 4; ++j) a[i][j] -= f * a[col][j];
        }
    }
    for (int i = 0; i < 3; ++i) out[i] = a[i][3] / a[i][i];
    return true;
}

// least-squares affine (px,py) -> (u,v) from n>=3 point pairs
bool fit_affine(const double* px, const double* py, const double* u,
                const double* v, int n, double m[2][3]) {
    double M[3][3] = {{0}}, ru[3] = {0}, rv[3] = {0};
    for (int i = 0; i < n; ++i) {
        const double row[3] = {px[i], py[i], 1.0};
        for (int a = 0; a < 3; ++a) {
            for (int b = 0; b < 3; ++b) M[a][b] += row[a] * row[b];
            ru[a] += row[a] * u[i];
            rv[a] += row[a] * v[i];
        }
    }
    double cu[3], cv[3];
    if (!solve3(M, ru, cu) || !solve3(M, rv, cv)) return false;
    for (int j = 0; j < 3; ++j) { m[0][j] = cu[j]; m[1][j] = cv[j]; }
    return true;
}

struct QuadGen {
    // shared quad-formation logic for index stars and image detections:
    // points are brightness-ordered; per anchor A pick up to nb most
    // distant partners B within [dmin, dmax] (euclidean in the given
    // 2-D/3-D metric), then C,D pairs inside the AB circle.
    int quads_per_anchor;
    int nb_choices;
};

}  // namespace

extern "C" {

// Build a quad index from a reference catalog (brightness-ordered).
//   ra, dec        : star positions [deg], brightest first
//   n              : number of stars
//   scale_min/max  : quad diameter range [deg]
//   quads_per_star : max quads anchored on each star
//   quad_out       : int32[max_quads*4] star indices (A,B,C,D canonical)
//   code_out       : double[max_quads*4] canonical codes, sorted by
//                    code[0] on return
// Returns the number of quads built (<= max_quads).
long quad_index_build(const double* ra, const double* dec, long n,
                      double scale_min, double scale_max,
                      int quads_per_star,
                      int32_t* quad_out, double* code_out,
                      long max_quads) {
    if (n < 4 || max_quads <= 0) return 0;
    std::vector<V3> xyz((size_t)n);
    for (long i = 0; i < n; ++i) xyz[(size_t)i] = radec2xyz(ra[i], dec[i]);

    // chord distance corresponding to an angle theta: 2 sin(theta/2)
    const double chord_max = 2.0 * std::sin(scale_max * D2R / 2.0);
    const double chord_min = 2.0 * std::sin(scale_min * D2R / 2.0);

    CellHash grid(std::max(chord_max, 1e-8));
    for (long i = 0; i < n; ++i) grid.insert(xyz[(size_t)i], (int32_t)i);

    std::unordered_set<uint64_t> seen;
    long nq = 0;

    std::vector<int32_t> nbr;
    for (long ia = 0; ia < n && nq < max_quads; ++ia) {
        const V3& A = xyz[(size_t)ia];
        nbr.clear();
        grid.around(A, [&](int32_t j) {
            if (j == ia) return;
            const V3& P = xyz[(size_t)j];
            const double dx = P.x - A.x, dy = P.y - A.y, dz = P.z - A.z;
            const double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 <= chord_max * chord_max) nbr.push_back(j);
        });
        if ((long)nbr.size() < 3) continue;
        std::sort(nbr.begin(), nbr.end());   // brightness order

        // candidate Bs: within [chord_min, chord_max] of A, BRIGHTEST
        // first — brightness-deterministic selection is what makes the
        // image side (which can only see bright detections) form the
        // same quads as the index side
        std::vector<int32_t> bs;
        for (int32_t j : nbr) {
            const V3& P = xyz[(size_t)j];
            const double dx = P.x - A.x, dy = P.y - A.y, dz = P.z - A.z;
            const double d = std::sqrt(dx * dx + dy * dy + dz * dz);
            if (d >= chord_min) bs.push_back(j);
        }

        int made = 0;
        for (size_t bi = 0; bi < bs.size() && bi < 4 &&
                            made < quads_per_star; ++bi) {
            const int32_t ib = bs[bi];
            const V3& B = xyz[(size_t)ib];
            const V3 mid = {(A.x + B.x) / 2, (A.y + B.y) / 2,
                            (A.z + B.z) / 2};
            const double r2 = 0.23 * ((B.x - A.x) * (B.x - A.x)
                                      + (B.y - A.y) * (B.y - A.y)
                                      + (B.z - A.z) * (B.z - A.z));
            // inner points, brightness-ordered (0.23 < 0.25: margin so
            // noisy codes stay inside the containment circle)
            std::vector<int32_t> inner;
            for (int32_t j : nbr) {
                if (j == ib) continue;
                const V3& P = xyz[(size_t)j];
                const double dx = P.x - mid.x, dy = P.y - mid.y,
                             dz = P.z - mid.z;
                if (dx * dx + dy * dy + dz * dz <= r2)
                    inner.push_back(j);
            }
            for (size_t ci = 0; ci + 1 < inner.size() &&
                                made < quads_per_star; ++ci) {
                for (size_t di = ci + 1; di < inner.size() &&
                                         made < quads_per_star; ++di) {
                    const int32_t ic = inner[ci], id = inner[di];
                    const uint64_t k = quad_key((int32_t)ia, ib, ic, id);
                    if (!seen.insert(k).second) continue;
                    const V3 T = normalize({
                        (A.x + B.x + xyz[(size_t)ic].x
                         + xyz[(size_t)id].x) / 4,
                        (A.y + B.y + xyz[(size_t)ic].y
                         + xyz[(size_t)id].y) / 4,
                        (A.z + B.z + xyz[(size_t)ic].z
                         + xyz[(size_t)id].z) / 4});
                    double px[4], py[4];
                    const int32_t ids[4] = {(int32_t)ia, ib, ic, id};
                    bool ok = true;
                    for (int q = 0; q < 4 && ok; ++q)
                        ok = gnomonic(xyz[(size_t)ids[q]], T,
                                      &px[q], &py[q]);
                    if (!ok) continue;
                    double code[4];
                    int perm[4];
                    if (!make_code(px, py, code, perm)) continue;
                    for (int q = 0; q < 4; ++q)
                        quad_out[nq * 4 + q] = ids[perm[q]];
                    std::memcpy(code_out + nq * 4, code,
                                4 * sizeof(double));
                    ++nq;
                    ++made;
                    if (nq >= max_quads) return nq;
                }
            }
        }
    }

    // sort by code[0] for range lookup
    std::vector<long> order((size_t)nq);
    for (long i = 0; i < nq; ++i) order[(size_t)i] = i;
    std::sort(order.begin(), order.end(), [&](long a, long b) {
        return code_out[a * 4] < code_out[b * 4];
    });
    std::vector<double> cs((size_t)nq * 4);
    std::vector<int32_t> qs((size_t)nq * 4);
    for (long i = 0; i < nq; ++i) {
        std::memcpy(&cs[(size_t)i * 4], code_out + order[(size_t)i] * 4,
                    4 * sizeof(double));
        std::memcpy(&qs[(size_t)i * 4], quad_out + order[(size_t)i] * 4,
                    4 * sizeof(int32_t));
    }
    std::memcpy(code_out, cs.data(), cs.size() * sizeof(double));
    std::memcpy(quad_out, qs.data(), qs.size() * sizeof(int32_t));
    return nq;
}

// Blind solve.  Detections brightness-ordered.
//   detx, dety      : detection pixel coords (0-based), ndet of them
//   nuse            : number of bright detections used to form quads
//   qpix_min/max    : detection-quad diameter range [pix]
//   width, height   : image bounds for verification
//   ra, dec, nref   : reference stars (same catalog the index was
//                     built from; used for verification)
//   quads, codes    : the index (codes sorted by first component)
//   code_tol        : L2 tolerance in code space
//   pix_tol         : verification match radius [pix]
//   min_match       : acceptance threshold on verified star matches
//   out10           : [nmatch, rms_arcsec, crval1, crval2, crpix1,
//                      crpix2, cd11, cd12, cd21, cd22]
// Returns nmatch of the best candidate, 0 if no acceptable solution.
long quad_solve(const double* detx, const double* dety, long ndet,
                long nuse, double qpix_min, double qpix_max,
                double width, double height,
                const double* ra, const double* dec, long nref,
                const int32_t* quads, const double* codes, long nquads,
                double code_tol, double pix_tol, long min_match,
                double* out10) {
    std::memset(out10, 0, 10 * sizeof(double));
    if (ndet < 4 || nref < 4 || nquads < 1) return 0;
    nuse = std::min(nuse, ndet);

    std::vector<V3> rxyz((size_t)nref);
    for (long i = 0; i < nref; ++i)
        rxyz[(size_t)i] = radec2xyz(ra[i], dec[i]);

    // 2-D grid over detections for verification lookups
    const double cell = std::max(pix_tol, 8.0);
    std::unordered_map<int64_t, std::vector<int32_t>> dgrid;
    auto dkey = [&](double x, double y) {
        return (((int64_t)std::floor(x / cell) + (1 << 24)) << 26)
               | ((int64_t)std::floor(y / cell) + (1 << 24));
    };
    for (long i = 0; i < ndet; ++i)
        dgrid[dkey(detx[i], dety[i])].push_back((int32_t)i);
    auto nearest_det = [&](double x, double y) -> double {
        double best = 1e30;
        for (int di = -1; di <= 1; ++di)
            for (int dj = -1; dj <= 1; ++dj) {
                auto it = dgrid.find(dkey(x + di * cell, y + dj * cell));
                if (it == dgrid.end()) continue;
                for (int32_t i : it->second) {
                    const double dx = detx[i] - x, dy = dety[i] - y;
                    best = std::min(best, dx * dx + dy * dy);
                }
            }
        return std::sqrt(best);
    };

    // verify one candidate affine m: pixel -> tangent plane at T
    long best_nmatch = 0;
    double best_rms = 1e30, best_out[10];
    auto verify = [&](const double m[2][3], const V3& T,
                      double Tra, double Tdec) {
        // invert the 2x2 part
        const double det = m[0][0] * m[1][1] - m[0][1] * m[1][0];
        if (std::fabs(det) < 1e-24) return;
        const double inv[2][2] = {{m[1][1] / det, -m[0][1] / det},
                                  {-m[1][0] / det, m[0][0] / det}};
        long nmatch = 0;
        double sum2 = 0.0;
        const double scale = std::sqrt(std::fabs(det));   // rad/pix
        for (long r = 0; r < nref; ++r) {
            double xi, eta;
            if (!gnomonic(rxyz[(size_t)r], T, &xi, &eta)) continue;
            const double u = xi - m[0][2], v = eta - m[1][2];
            const double px = inv[0][0] * u + inv[0][1] * v;
            const double py = inv[1][0] * u + inv[1][1] * v;
            if (px < 0 || px >= width || py < 0 || py >= height)
                continue;
            const double d = nearest_det(px, py);
            if (d < pix_tol) {
                ++nmatch;
                sum2 += d * d;
            }
        }
        if (nmatch < min_match || nmatch <= best_nmatch) return;
        const double rms_arcsec =
            std::sqrt(sum2 / (double)nmatch) * scale / D2R * 3600.0;
        best_nmatch = nmatch;
        best_rms = rms_arcsec;
        best_out[0] = (double)nmatch;
        best_out[1] = rms_arcsec;
        // WCS: CRVAL at T; CRPIX where the tangent plane origin lands
        best_out[2] = Tra;
        best_out[3] = Tdec;
        const double b0 = -m[0][2], b1 = -m[1][2];
        best_out[4] = (inv[0][0] * b0 + inv[0][1] * b1) + 1.0;
        best_out[5] = (inv[1][0] * b0 + inv[1][1] * b1) + 1.0;
        best_out[6] = m[0][0] / D2R;
        best_out[7] = m[0][1] / D2R;
        best_out[8] = m[1][0] / D2R;
        best_out[9] = m[1][1] / D2R;
    };

    // form detection quads and query the index
    const long hi_exit = std::max(50L, 3 * min_match);
    for (long ia = 0; ia < nuse; ++ia) {
        for (long ib = ia + 1; ib < nuse; ++ib) {
            const double dxab = detx[ib] - detx[ia];
            const double dyab = dety[ib] - dety[ia];
            const double dab = std::sqrt(dxab * dxab + dyab * dyab);
            if (dab < qpix_min || dab > qpix_max) continue;
            const double mx = (detx[ia] + detx[ib]) / 2;
            const double my = (dety[ia] + dety[ib]) / 2;
            const double r2 = 0.23 * dab * dab;
            std::vector<int32_t> inner;
            for (long j = 0; j < nuse; ++j) {
                if (j == ia || j == ib) continue;
                const double dx = detx[j] - mx, dy = dety[j] - my;
                if (dx * dx + dy * dy <= r2)
                    inner.push_back((int32_t)j);
            }
            int tried = 0;
            for (size_t ci = 0; ci + 1 < inner.size() && tried < 48;
                 ++ci) {
                for (size_t di = ci + 1; di < inner.size() && tried < 48;
                     ++di) {
                    ++tried;
                    const long ids[4] = {ia, ib, inner[ci], inner[di]};
                    // both parities: pixel grid may be mirrored
                    for (int par = 0; par < 2; ++par) {
                        double px[4], py[4];
                        for (int q = 0; q < 4; ++q) {
                            px[q] = par ? dety[ids[q]] : detx[ids[q]];
                            py[q] = par ? detx[ids[q]] : dety[ids[q]];
                        }
                        double code[4];
                        int perm[4];
                        if (!make_code(px, py, code, perm)) continue;
                        // canonical-slot order of the detections
                        double spx[4], spy[4];
                        for (int q = 0; q < 4; ++q) {
                            spx[q] = detx[ids[perm[q]]];
                            spy[q] = dety[ids[perm[q]]];
                        }
                        // range scan on code[0]
                        long lo = 0, hi = nquads;
                        const double c0 = code[0] - code_tol;
                        while (lo < hi) {
                            const long mid = (lo + hi) / 2;
                            if (codes[mid * 4] < c0) lo = mid + 1;
                            else hi = mid;
                        }
                        for (long qi = lo;
                             qi < nquads
                             && codes[qi * 4] <= code[0] + code_tol;
                             ++qi) {
                            double d2 = 0;
                            for (int q = 0; q < 4; ++q) {
                                const double d = codes[qi * 4 + q]
                                                 - code[q];
                                d2 += d * d;
                            }
                            if (d2 > code_tol * code_tol) continue;
                            // candidate: fit affine from 4 pairs
                            V3 Tsum = {0, 0, 0};
                            for (int q = 0; q < 4; ++q) {
                                const V3 s = radec2xyz(
                                    ra[quads[qi * 4 + q]],
                                    dec[quads[qi * 4 + q]]);
                                Tsum.x += s.x;
                                Tsum.y += s.y;
                                Tsum.z += s.z;
                            }
                            const V3 T = normalize(Tsum);
                            double Txi, Teta;
                            {   // tangent point sky coords
                                Txi = std::atan2(T.y, T.x) / D2R;
                                if (Txi < 0) Txi += 360.0;
                                Teta = std::asin(
                                    std::max(-1.0, std::min(1.0, T.z)))
                                    / D2R;
                            }
                            double u[4], v[4];
                            bool ok = true;
                            for (int q = 0; q < 4 && ok; ++q) {
                                const V3 s = radec2xyz(
                                    ra[quads[qi * 4 + q]],
                                    dec[quads[qi * 4 + q]]);
                                ok = gnomonic(s, T, &u[q], &v[q]);
                            }
                            if (!ok) continue;
                            double m[2][3];
                            if (!fit_affine(spx, spy, u, v, 4, m))
                                continue;
                            verify(m, T, Txi, Teta);
                            if (best_nmatch >= hi_exit) {
                                std::memcpy(out10, best_out,
                                            10 * sizeof(double));
                                return best_nmatch;
                            }
                        }
                    }
                }
            }
        }
    }
    if (best_nmatch > 0)
        std::memcpy(out10, best_out, 10 * sizeof(double));
    (void)best_rms;
    return best_nmatch;
}

}  // extern "C"

// COCO mask operations: RLE decode and polygon -> mask rasterization.
//
// The port's own copy of the JAX package's native/coco_mask.cpp, in place
// of the pycocotools `_mask` C extension the reference depends on
// (reference data_kits/coco.py:261 rasterizes class masks from polygon and
// RLE annotations on the host). It implements the COCO mask format --
// column-major RLE, the compressed LEB128-style count string, and the
// 5x-upsampled boundary polygon fill -- so masks match the official
// rasterization bit for bit. The loader's worker threads call it through
// ctypes on numpy buffers (ctypes releases the GIL for the call).
//
// Build: g++ -O2 -shared -fPIC -o libcoco_mask.so coco_mask.cpp
// (pemp_tpu_torch/data/mask_ops.py does it at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Decode the COCO compressed count string into uint32 run lengths.
// Returns the number of counts written (<= max_counts), or -1 on overflow.
int rle_from_string(const char* s, uint32_t* counts, int max_counts) {
    int m = 0;
    size_t p = 0;
    while (s[p]) {
        long x = 0;
        int k = 0, more = 1;
        while (more) {
            long c = (long)(s[p]) - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (int)(c & 0x20);
            p++;
            k++;
            if (!more && (c & 0x10)) x |= -1L << (5 * k);
        }
        if (m > 2) x += (long)counts[m - 2];
        if (m >= max_counts) return -1;
        counts[m++] = (uint32_t)x;
    }
    return m;
}

// Decode run lengths (alternating 0-runs / 1-runs, column-major) into a
// row-major uint8 mask [h, w].
void rle_decode(const uint32_t* counts, int n, int h, int w, uint8_t* out) {
    long pos = 0;
    uint8_t value = 0;
    const long total = (long)h * (long)w;
    for (int i = 0; i < n; i++) {
        long run = (long)counts[i];
        for (long j = 0; j < run && pos < total; j++, pos++) {
            // column-major position -> row-major index
            long col = pos / h, row = pos % h;
            out[row * w + col] = value;
        }
        value = 1 - value;
    }
}

// Rasterize one polygon ring into column-major run lengths, matching the
// official COCO semantics: vertices upsampled 5x, dense boundary walk,
// column-crossing extraction, parity fill via sorted crossing positions.
// xy: [x0, y0, x1, y1, ...] of k vertices. Returns count of runs written
// into `counts` (caller provides capacity >= h*w+1), or -1 on failure.
int poly_to_rle(const double* xy, int k, int h, int w,
                uint32_t* counts, int max_counts) {
    const double scale = 5.0;
    std::vector<long> x(k + 1), y(k + 1);
    for (int j = 0; j < k; j++) {
        x[j] = (long)(scale * xy[j * 2 + 0] + 0.5);
        y[j] = (long)(scale * xy[j * 2 + 1] + 0.5);
    }
    x[k] = x[0];
    y[k] = y[0];

    // dense boundary points along every edge, emitted in the edge's
    // ORIGINAL direction (the flip/t indexing): the downsampling step
    // below reads consecutive pairs, so walk order is semantic
    std::vector<long> u, v;
    for (int j = 0; j < k; j++) {
        long xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
        long dx = std::labs(xe - xs), dy = std::labs(ys - ye);
        bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
        if (flip) { std::swap(xs, xe); std::swap(ys, ye); }
        if (dx >= dy) {
            double s = dx == 0 ? 0 : (double)(ye - ys) / (double)dx;
            for (long d = 0; d <= dx; d++) {
                long t = flip ? dx - d : d;
                u.push_back(t + xs);
                v.push_back((long)(ys + s * (double)t + 0.5));
            }
        } else {
            double s = dy == 0 ? 0 : (double)(xe - xs) / (double)dy;
            for (long d = 0; d <= dy; d++) {
                long t = flip ? dy - d : d;
                v.push_back(t + ys);
                u.push_back((long)(xs + s * (double)t + 0.5));
            }
        }
    }

    // column-crossing points, downsampled back to pixel grid
    size_t m = u.size();
    std::vector<long> px, py;
    for (size_t j = 1; j < m; j++) {
        if (u[j] == u[j - 1]) continue;
        double xd = (double)(u[j] < u[j - 1] ? u[j] : u[j] - 1);
        xd = (xd + 0.5) / scale - 0.5;
        if (std::floor(xd) != xd || xd < 0 || xd > (double)(w - 1)) continue;
        double yd = (double)(v[j] < v[j - 1] ? v[j] : v[j - 1]);
        yd = (yd + 0.5) / scale - 0.5;
        if (yd < 0) yd = 0; else if (yd > (double)h) yd = (double)h;
        yd = std::ceil(yd);
        px.push_back((long)xd);
        py.push_back((long)yd);
    }

    // crossings -> column-major positions -> deltas -> parity runs
    std::vector<uint32_t> a;
    size_t kk = px.size();
    for (size_t j = 0; j < kk; j++)
        a.push_back((uint32_t)(px[j] * (long)h + py[j]));
    a.push_back((uint32_t)((long)h * (long)w));
    std::sort(a.begin(), a.end());
    uint32_t p = 0;
    for (size_t j = 0; j < a.size(); j++) {
        uint32_t t = a[j];
        a[j] -= p;
        p = t;
    }
    // merge: first value starts a 0-run; zero deltas merge into neighbors
    std::vector<uint32_t> b;
    b.push_back(a[0]);
    size_t j = 1;
    while (j < a.size()) {
        if (a[j] > 0) {
            b.push_back(a[j]);
            j++;
        } else {
            j++;
            if (j < a.size()) {
                b[b.size() - 1] += a[j];
                j++;
            }
        }
    }
    if ((int)b.size() > max_counts) return -1;
    std::memcpy(counts, b.data(), b.size() * sizeof(uint32_t));
    return (int)b.size();
}

// Convenience: rasterize several polygon rings (one object's segmentation)
// directly into a row-major uint8 mask via union.
// sizes[i] = number of vertices of ring i; xy holds all rings contiguous.
int polys_to_mask(const double* xy, const int* sizes, int n_polys,
                  int h, int w, uint8_t* out) {
    std::vector<uint32_t> counts((size_t)h * w + 2);
    std::vector<uint8_t> tmp((size_t)h * w);
    std::memset(out, 0, (size_t)h * w);
    const double* ptr = xy;
    for (int i = 0; i < n_polys; i++) {
        int k = sizes[i] / 2;
        int n = poly_to_rle(ptr, k, h, w, counts.data(), (int)counts.size());
        if (n < 0) return -1;
        std::memset(tmp.data(), 0, tmp.size());
        rle_decode(counts.data(), n, h, w, tmp.data());
        for (size_t t = 0; t < tmp.size(); t++) out[t] |= tmp[t];
        ptr += sizes[i];
    }
    return 0;
}

}  // extern "C"

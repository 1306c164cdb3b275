// Straightening guides of the geometry preview: Canny edges, the standard
// Hough transform and 8-connected line drawing, each as OpenCV computes
// cv2.Canny(gray, low, high) (aperture 3, L1 gradient), cv2.HoughLines(edges,
// rho, theta, threshold) and cv2.line(img, p1, p2, color, 1), which the JAX
// package's service calls (rapidraw_tpu/pipeline/service.py:535-571).
//
// Canny: 3x3 Sobel in int16 with replicated borders, |dx| + |dy|, non-maximum
// suppression by OpenCV's integer tangent test (tan 22.5 deg as 13573 / 2^15;
// strict on one side, non-strict on the other), zero magnitude outside the
// image, then hysteresis: a candidate (m > low, a local maximum) belongs to
// an edge when it is 8-connected through candidates to one with m > high.
//
// HoughLines: OpenCV's accumulator of (numangle + 2) x (numrho + 2) ints,
// its float trig table built by adding the angle step in float, rho indices
// rounded half to even (cvRound), local maxima by its 4-neighbour test
// (strict towards the lower index, non-strict towards the higher), sorted
// by votes descending then by accumulator index ascending.
//
// line: OpenCV's LineIterator (8-connected Bresenham, drawn left to right)
// after clipLine's clipping to the image.
//
// Built with g++ at first use (rapidraw_tpu_torch/native.py host_library);
// no floating-point contraction, so the float sums round as OpenCV's.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

extern "C" {

// gray (h, w) u8 -> edges (h, w) u8, 255 on an edge, else 0. Returns 0.
int guides_canny(const uint8_t* gray, int h, int w, int low, int high, uint8_t* edges) {
    if (h <= 0 || w <= 0) return 0;
    std::vector<int16_t> dx((size_t)h * w), dy((size_t)h * w);
    auto px = [&](int y, int x) -> int {
        y = y < 0 ? 0 : (y >= h ? h - 1 : y);
        x = x < 0 ? 0 : (x >= w ? w - 1 : x);
        return gray[(size_t)y * w + x];
    };
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            int gx = (px(y - 1, x + 1) - px(y - 1, x - 1)) + 2 * (px(y, x + 1) - px(y, x - 1)) +
                     (px(y + 1, x + 1) - px(y + 1, x - 1));
            int gy = (px(y + 1, x - 1) + 2 * px(y + 1, x) + px(y + 1, x + 1)) -
                     (px(y - 1, x - 1) + 2 * px(y - 1, x) + px(y - 1, x + 1));
            dx[(size_t)y * w + x] = (int16_t)gx;
            dy[(size_t)y * w + x] = (int16_t)gy;
        }
    // magnitude with a zero border of one pixel all round
    const int ms = w + 2;
    std::vector<int> mag((size_t)(h + 2) * ms, 0);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            mag[(size_t)(y + 1) * ms + x + 1] =
                std::abs((int)dx[(size_t)y * w + x]) + std::abs((int)dy[(size_t)y * w + x]);
    // map: 0 candidate, 1 not an edge, 2 edge
    std::vector<uint8_t> map((size_t)h * w, 1);
    std::vector<int> stack;
    const int TG22 = 13573;
    for (int y = 0; y < h; ++y) {
        const int* p = &mag[(size_t)y * ms + 1];
        const int* a = &mag[(size_t)(y + 1) * ms + 1];
        const int* n = &mag[(size_t)(y + 2) * ms + 1];
        for (int x = 0; x < w; ++x) {
            int m = a[x];
            if (m <= low) continue;
            int xs = dx[(size_t)y * w + x], ys = dy[(size_t)y * w + x];
            int ax = std::abs(xs);
            int ay = std::abs(ys) << 15;
            int tg22x = ax * TG22;
            bool peak;
            if (ay < tg22x) {
                peak = m > a[x - 1] && m >= a[x + 1];
            } else {
                int tg67x = tg22x + (ax << 16);
                if (ay > tg67x) {
                    peak = m > p[x] && m >= n[x];
                } else {
                    int s = (xs ^ ys) < 0 ? -1 : 1;
                    peak = m > p[x - s] && m > n[x + s];
                }
            }
            if (!peak) continue;
            if (m > high) {
                map[(size_t)y * w + x] = 2;
                stack.push_back(y * w + x);
            } else {
                map[(size_t)y * w + x] = 0;
            }
        }
    }
    while (!stack.empty()) {
        int i = stack.back();
        stack.pop_back();
        int y = i / w, x = i % w;
        for (int ddy = -1; ddy <= 1; ++ddy)
            for (int ddx = -1; ddx <= 1; ++ddx) {
                int yy = y + ddy, xx = x + ddx;
                if ((ddy == 0 && ddx == 0) || yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
                uint8_t& v = map[(size_t)yy * w + xx];
                if (v == 0) {
                    v = 2;
                    stack.push_back(yy * w + xx);
                }
            }
    }
    for (size_t i = 0; i < (size_t)h * w; ++i) edges[i] = map[i] == 2 ? 255 : 0;
    return 0;
}

// edges (h, w) u8 -> up to `cap` lines (rho, theta) as float pairs, sorted
// as cv2.HoughLines returns them over [0, pi). Returns the number of lines
// found (more than cap: the caller retries with a larger buffer).
long guides_hough(const uint8_t* edges, int h, int w, float rho, float theta, int threshold,
                  float* out, long cap) {
    const double min_theta = 0.0, max_theta = M_PI;
    float irho = 1 / rho;
    int max_rho = w + h, min_rho = -max_rho;
    int numangle = (int)std::lrint((max_theta - min_theta) / theta);
    int numrho = (int)std::lrint(((max_rho - min_rho) + 1) / rho);
    std::vector<int> accum((size_t)(numangle + 2) * (numrho + 2), 0);
    std::vector<float> tab_sin(numangle), tab_cos(numangle);
    float ang = (float)min_theta;
    for (int n = 0; n < numangle; ang += (float)theta, n++) {
        tab_sin[n] = (float)(std::sin((double)ang) * irho);
        tab_cos[n] = (float)(std::cos((double)ang) * irho);
    }
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            if (edges[(size_t)i * w + j] == 0) continue;
            for (int n = 0; n < numangle; n++) {
                float v = (float)j * tab_cos[n] + (float)i * tab_sin[n];
                int r = (int)std::lrintf(v);
                r += (numrho - 1) / 2;
                accum[(size_t)(n + 1) * (numrho + 2) + r + 1]++;
            }
        }
    std::vector<int> buf;
    for (int r = 0; r < numrho; r++)
        for (int n = 0; n < numangle; n++) {
            int base = (n + 1) * (numrho + 2) + r + 1;
            int v = accum[base];
            if (v > threshold && v > accum[base - 1] && v >= accum[base + 1] &&
                v > accum[base - numrho - 2] && v >= accum[base + numrho + 2])
                buf.push_back(base);
        }
    std::sort(buf.begin(), buf.end(), [&](int l1, int l2) {
        return accum[l1] > accum[l2] || (accum[l1] == accum[l2] && l1 < l2);
    });
    long total = (long)buf.size();
    double scale = 1. / (numrho + 2);
    for (long i = 0; i < total && i < cap; i++) {
        int idx = buf[i];
        int n = (int)std::floor(idx * scale) - 1;
        int r = idx - (n + 1) * (numrho + 2) - 1;
        out[2 * i] = (r - (numrho - 1) * 0.5f) * rho;
        out[2 * i + 1] = (float)min_theta + n * theta;
    }
    return total;
}

static bool clip_line(int64_t width, int64_t height, int64_t& x1, int64_t& y1, int64_t& x2,
                      int64_t& y2) {
    int64_t right = width - 1, bottom = height - 1;
    if (width <= 0 || height <= 0) return false;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// Draw an 8-connected line of one pixel's width into (h, w, 3) u8 rgb.
// Returns the number of pixels drawn.
int guides_line(uint8_t* rgb, int h, int w, int x1, int y1, int x2, int y2, int r, int g, int b) {
    int64_t X1 = x1, Y1 = y1, X2 = x2, Y2 = y2;
    if ((unsigned)x1 >= (unsigned)w || (unsigned)x2 >= (unsigned)w ||
        (unsigned)y1 >= (unsigned)h || (unsigned)y2 >= (unsigned)h) {
        if (!clip_line(w, h, X1, Y1, X2, Y2)) return 0;
    }
    int px1 = (int)X1, py1 = (int)Y1, px2 = (int)X2, py2 = (int)Y2;
    int delta_x = 1, delta_y = 1;
    int dx = px2 - px1, dy = py2 - py1;
    if (dx < 0) {  // left to right
        dx = -dx;
        dy = -dy;
        std::swap(px1, px2);
        std::swap(py1, py2);
    }
    if (dy < 0) {
        dy = -dy;
        delta_y = -1;
    }
    bool vert = dy > dx;
    if (vert) {
        std::swap(dx, dy);
        std::swap(delta_x, delta_y);
    }
    int err = dx - (dy + dy);
    int plus_delta = dx + dx, minus_delta = -(dy + dy);
    int minus_shift = delta_x, plus_shift = 0, minus_step = 0, plus_step = delta_y;
    int count = dx + 1;
    if (vert) {
        std::swap(plus_step, plus_shift);
        std::swap(minus_step, minus_shift);
    }
    int x = px1, y = py1;
    for (int i = 0; i < count; i++) {
        uint8_t* p = rgb + ((size_t)y * w + x) * 3;
        p[0] = (uint8_t)r;
        p[1] = (uint8_t)g;
        p[2] = (uint8_t)b;
        int mask = err < 0 ? -1 : 0;
        err += minus_delta + (plus_delta & mask);
        x += minus_shift + (plus_shift & mask);
        y += minus_step + (plus_step & mask);
    }
    return count;
}

}  // extern "C"

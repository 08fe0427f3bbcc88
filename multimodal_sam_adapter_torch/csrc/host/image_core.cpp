// Host-pipeline image core of the PyTorch port: PNG scanline unfiltering
// (data/image_io.py) and the two-tap float32 resize of the test and train
// pipelines (data/resize.py). Both depend on the value just computed to
// their left or above, so numpy cannot vectorise them; each has a numpy
// twin in those modules, bit-equal to it (tests/test_torch_image_io.py).
//
// Built with -ffp-contract=off: every multiply and add rounds on its own,
// and a fused multiply-add happens only where std::fma asks for one. The
// resize loops are compiled twice on x86-64 (target_clones), once with the
// FMA instructions, so std::fma is one instruction where the CPU has it
// and a libm call where it does not; the result is the same.
//
// Exposed through a C ABI for ctypes; built at first use, with
// pipeline_core.cpp into one library, by
// multimodal_sam_adapter_torch/data/native.py.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__x86_64__) && defined(__GNUC__) && !defined(__clang__)
#define MSA_FMA_CLONES __attribute__((target_clones("fma", "default")))
#else
#define MSA_FMA_CLONES
#endif

namespace {

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    return (uint8_t)(pb <= pc ? b : c);
}

// One output row of the horizontal pass: n = dw * cn values.
// mode 0: s0 * a0 + s1 * a1 (OpenCV's own resize);
// mode 1: fma(s1 - s0, w, s0), w in a1 (the IPP resize OpenCV calls).
MSA_FMA_CLONES
void hrow(const float* srow, int sstride, int dw, int cn, const int* x0,
          const int* x1, const float* a0, const float* a1, int mode,
          float* out) {
    for (int dx = 0; dx < dw; ++dx) {
        const float* p0 = srow + (int64_t)x0[dx] * sstride;
        const float* p1 = srow + (int64_t)x1[dx] * sstride;
        float* o = out + (int64_t)dx * cn;
        if (mode == 0) {
            for (int c = 0; c < cn; ++c) o[c] = p0[c] * a0[dx] + p1[c] * a1[dx];
        } else {
            for (int c = 0; c < cn; ++c)
                o[c] = std::fma(p1[c] - p0[c], a1[dx], p0[c]);
        }
    }
}

// The vertical pass of one output row from the horizontal rows h0, h1.
// mode 0: h0 * b0 + h1 * b1; mode 1: fma(h1 - h0, b1, h0) where fused[i],
// h0 + (h1 - h0) * b1 elsewhere.
MSA_FMA_CLONES
void vrow(const float* h0, const float* h1, int dw, int cn, float b0,
          float b1, const uint8_t* fused, int mode, float* drow,
          int dstride) {
    for (int dx = 0; dx < dw; ++dx) {
        const float* p0 = h0 + (int64_t)dx * cn;
        const float* p1 = h1 + (int64_t)dx * cn;
        const uint8_t* f = fused + (int64_t)dx * cn;
        float* o = drow + (int64_t)dx * dstride;
        if (mode == 0) {
            for (int c = 0; c < cn; ++c) o[c] = p0[c] * b0 + p1[c] * b1;
        } else {
            for (int c = 0; c < cn; ++c) {
                float d = p1[c] - p0[c];
                o[c] = f[c] ? std::fma(d, b1, p0[c]) : p0[c] + d * b1;
            }
        }
    }
}

}  // namespace

extern "C" {

// PNG scanlines -> raw rows. data: h rows of 1 + rowbytes bytes, each a
// filter type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) and the filtered
// bytes; out: h x rowbytes. bpp: bytes of a whole pixel, at least 1.
// Returns 0, or 1 + the index of the first row with an unknown filter type
// (the rows before it are decoded).
int msa_png_unfilter(const uint8_t* data, int h, int rowbytes, int bpp,
                     uint8_t* out) {
    for (int y = 0; y < h; ++y) {
        const uint8_t* in = data + (int64_t)y * (rowbytes + 1);
        const int ft = in[0];
        ++in;
        uint8_t* cur = out + (int64_t)y * rowbytes;
        const uint8_t* prev = y ? cur - rowbytes : nullptr;
        switch (ft) {
            case 0:
                memcpy(cur, in, rowbytes);
                break;
            case 1:
                for (int i = 0; i < rowbytes; ++i)
                    cur[i] = (uint8_t)(in[i] + (i >= bpp ? cur[i - bpp] : 0));
                break;
            case 2:
                for (int i = 0; i < rowbytes; ++i)
                    cur[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
                break;
            case 3:
                for (int i = 0; i < rowbytes; ++i) {
                    int left = i >= bpp ? cur[i - bpp] : 0;
                    int up = prev ? prev[i] : 0;
                    cur[i] = (uint8_t)(in[i] + ((left + up) >> 1));
                }
                break;
            case 4:
                for (int i = 0; i < rowbytes; ++i) {
                    int left = i >= bpp ? cur[i - bpp] : 0;
                    int up = prev ? prev[i] : 0;
                    int ul = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    cur[i] = (uint8_t)(in[i] + paeth(left, up, ul));
                }
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}

// Two-tap separable resize of cn float32 channels: src (pixels `sstride`
// floats apart, rows sw * sstride apart) -> dst (dh rows, pixels
// `dstride` floats apart), so a chunk of a wider image's channels resizes
// in place. Per output column dx: source columns x0[dx], x1[dx] and weights
// a0[dx], a1[dx]; per output row dy: source rows y0[dy], y1[dy] and weights
// b0[dy], b1[dy] (all in range: the caller clamps). mode 0 and 1 as in
// hrow / vrow; fused: dw * cn flags (mode 1).
void msa_resize_f32(const float* src, int sw, int sstride, float* dst,
                    int dh, int dw, int dstride, int cn, const int* x0,
                    const int* x1, const float* a0, const float* a1,
                    const int* y0, const int* y1, const float* b0,
                    const float* b1, const uint8_t* fused, int mode) {
    const int64_t n = (int64_t)dw * cn;
    std::vector<float> buf(2 * n);
    float* rows[2] = {buf.data(), buf.data() + n};
    int held[2] = {-1, -1};
    const int64_t srow = (int64_t)sw * sstride;
    for (int dy = 0; dy < dh; ++dy) {
        const int want[2] = {y0[dy], y1[dy]};
        int slot[2];
        for (int k = 0; k < 2; ++k) {
            if (held[0] == want[k] || held[1] == want[k]) {
                slot[k] = held[0] == want[k] ? 0 : 1;
                continue;
            }
            // a horizontal row the other tap does not hold is overwritten
            const int other = want[1 - k];
            slot[k] = (k == 1) ? 1 - slot[0] : (held[0] == other ? 1 : 0);
            hrow(src + want[k] * srow, sstride, dw, cn, x0, x1, a0, a1, mode,
                 rows[slot[k]]);
            held[slot[k]] = want[k];
        }
        vrow(rows[slot[0]], rows[slot[1]], dw, cn, b0[dy], b1[dy], fused,
             mode, dst + (int64_t)dy * dw * dstride, dstride);
    }
}

}  // extern "C"

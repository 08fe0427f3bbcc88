// Host-pipeline core of the PyTorch port: fused per-modality normalize +
// channel flip + pad in a single pass over the image. The port's own copy of
// the JAX package's native/pipeline_core.cpp, held equal to it by
// tests/test_torch_train_data.py.
//
// The numpy expression of normalize + pad makes ~6 full passes over a
// 1024^2 x 6-channel float image; this makes one read and one write:
//   per modality slice: optional /255 (norm_by_max), optional BGR->RGB
//   channel flip, (x - mean) / std; then bottom/right padding.
//
// The transform collapses to dst[d] = src[k] * a[k] + b[k] with a channel
// permutation, precomputed per channel, so the row loop is multiply-adds
// the compiler can vectorize (templated on the channel count for the
// common layouts). Built with -ffp-contract=off, so every multiply and add
// rounds on its own and multimodal_sam_adapter_torch/data/native.py's numpy
// version of the same arithmetic is bit-equal to it.
//
// Exposed through a C ABI for ctypes; built at first use by
// multimodal_sam_adapter_torch/data/native.py.

#include <cstdint>
#include <cstring>

namespace {

template <int C>
void normalize_rows_fixed(const float* __restrict img, int h, int w,
                          float* __restrict out, int out_h, int out_w,
                          const int* __restrict dst,
                          const float* __restrict a,
                          const float* __restrict b, float pad_val) {
    for (int y = 0; y < out_h; ++y) {
        float* __restrict orow = out + (int64_t)y * out_w * C;
        if (y >= h) {
            for (int i = 0; i < out_w * C; ++i) orow[i] = pad_val;
            continue;
        }
        const float* __restrict irow = img + (int64_t)y * w * C;
        for (int x = 0; x < w; ++x) {
            const float* __restrict ipx = irow + (int64_t)x * C;
            float* __restrict opx = orow + (int64_t)x * C;
#pragma GCC unroll 16
            for (int k = 0; k < C; ++k) opx[dst[k]] = ipx[k] * a[k] + b[k];
        }
        for (int i = w * C; i < out_w * C; ++i) orow[i] = pad_val;
    }
}

void normalize_rows_any(const float* img, int h, int w, int c, float* out,
                        int out_h, int out_w, const int* dst, const float* a,
                        const float* b, float pad_val) {
    for (int y = 0; y < out_h; ++y) {
        float* orow = out + (int64_t)y * out_w * c;
        if (y >= h) {
            for (int i = 0; i < out_w * c; ++i) orow[i] = pad_val;
            continue;
        }
        const float* irow = img + (int64_t)y * w * c;
        for (int x = 0; x < w; ++x) {
            const float* ipx = irow + (int64_t)x * c;
            float* opx = orow + (int64_t)x * c;
            for (int k = 0; k < c; ++k) opx[dst[k]] = ipx[k] * a[k] + b[k];
        }
        for (int i = w * c; i < out_w * c; ++i) orow[i] = pad_val;
    }
}

}  // namespace

extern "C" {

// img:    (h, w, c) float32, modality channels concatenated
// out:    (out_h, out_w, c) float32, pre-zeroed not required
// n_mod:  number of modalities; ch[i] channels of modality i
// mean/std: concatenated per-channel stats (AFTER any flip), length c
// flip[i]: nonzero -> reverse the channel order within modality i
// div255[i]: nonzero -> divide modality i by 255 first
// pad_val: fill value for padded area (labels use a separate path)
void msa_normalize_pad(
    const float* img, int h, int w, int c,
    float* out, int out_h, int out_w,
    int n_mod, const int* ch,
    const float* mean, const float* stdev,
    const int* flip, const int* div255,
    float pad_val)
{
    // per-source-channel fused transform: out[dst[k]] = src[k]*a[k] + b[k]
    int dst[64];
    float a[64], b[64];
    int base = 0;
    for (int m = 0; m < n_mod; ++m) {
        for (int j = 0; j < ch[m]; ++j) {
            int src = base + j;
            int d = flip[m] ? (base + ch[m] - 1 - j) : src;
            float pre = div255[m] ? (1.0f / 255.0f) : 1.0f;
            dst[src] = d;
            a[src] = pre / stdev[d];
            b[src] = -mean[d] / stdev[d];
        }
        base += ch[m];
    }

    switch (c) {
        case 3:  normalize_rows_fixed<3>(img, h, w, out, out_h, out_w,
                                         dst, a, b, pad_val); break;
        case 4:  normalize_rows_fixed<4>(img, h, w, out, out_h, out_w,
                                         dst, a, b, pad_val); break;
        case 6:  normalize_rows_fixed<6>(img, h, w, out, out_h, out_w,
                                         dst, a, b, pad_val); break;
        case 9:  normalize_rows_fixed<9>(img, h, w, out, out_h, out_w,
                                         dst, a, b, pad_val); break;
        default: normalize_rows_any(img, h, w, c, out, out_h, out_w,
                                    dst, a, b, pad_val); break;
    }
}

// label pad: (h, w) uint8 -> (out_h, out_w) with pad_val
void msa_pad_label(
    const uint8_t* lab, int h, int w,
    uint8_t* out, int out_h, int out_w, uint8_t pad_val)
{
    for (int y = 0; y < out_h; ++y) {
        uint8_t* orow = out + (int64_t)y * out_w;
        if (y >= h) {
            memset(orow, pad_val, out_w);
            continue;
        }
        memcpy(orow, lab + (int64_t)y * w, w);
        if (out_w > w) memset(orow + w, pad_val, out_w - w);
    }
}

}  // extern "C"

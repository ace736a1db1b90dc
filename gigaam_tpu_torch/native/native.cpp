// Native host-side kernels for gigaam_tpu_torch (copy of gigaam_tpu/native).
//
// The reference offloads all host audio/metric work to third-party native
// code: ffmpeg's C decoder (gigaam/preprocess.py:16-34), torchaudio's C++
// resampler (gigaam/utils.py:345-359), and the editdistance C++ package
// (train_utils/module.py:5,185).  These are the in-tree equivalents,
// exposed through a plain C ABI and loaded via ctypes (no pybind11 in the
// build image).  The device compute path never calls into here — this is the
// data-loader / eval-metric side of the runtime.
//
// Build: g++ -O3 -march=native -shared -fPIC -o _native.so native.cpp

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>
#include <cmath>

extern "C" {

// s16le PCM -> float32 in [-1, 1): the ffmpeg-pipe conversion inner loop
// (reference divides by 32768, gigaam/preprocess.py:40).
void s16_to_f32(const int16_t* in, float* out, int64_t n) {
    constexpr float kScale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * kScale;
}

// Mix interleaved multi-channel s16 to mono float32.
void s16_interleaved_to_mono_f32(const int16_t* in, float* out,
                                 int64_t frames, int32_t channels) {
    const float scale = 1.0f / (32768.0f * channels);
    for (int64_t i = 0; i < frames; ++i) {
        int32_t acc = 0;
        for (int32_t c = 0; c < channels; ++c) acc += in[i * channels + c];
        out[i] = acc * scale;
    }
}

// Polyphase FIR resampler (upfirdn): y[m] = sum_j h[j] * x_up[m*down - j]
// over the zero-stuffed upsampled signal.  Matches scipy.signal's
// resample_poly structure; taps are supplied by the caller (kaiser-windowed
// sinc, built host-side in Python).
void resample_poly_f32(const float* in, int64_t n_in, float* out,
                       int64_t n_out, const float* taps, int64_t n_taps,
                       int64_t up, int64_t down, int64_t offset) {
    for (int64_t m = 0; m < n_out; ++m) {
        // position in the upsampled stream
        const int64_t pos = m * down + offset;
        float acc = 0.0f;
        // x_up[pos - j] != 0 only when (pos - j) % up == 0
        int64_t j0 = pos % up;  // smallest j with (pos - j) divisible by up
        for (int64_t j = j0; j < n_taps; j += up) {
            const int64_t idx = (pos - j) / up;
            if (idx < 0) break;          // j increasing => idx decreasing
            if (idx >= n_in) continue;
            acc += taps[j] * in[idx];
        }
        out[m] = acc * up;
    }
}

// Levenshtein distance over int32 id sequences (words or tokens are
// mapped to ids in Python).  Replaces the editdistance C++ dependency.
int64_t levenshtein_i32(const int32_t* a, int64_t na,
                        const int32_t* b, int64_t nb) {
    if (na < nb) { std::swap(a, b); std::swap(na, nb); }
    if (nb == 0) return na;
    std::vector<int64_t> prev(nb + 1), cur(nb + 1);
    for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
    for (int64_t i = 1; i <= na; ++i) {
        cur[0] = i;
        const int32_t ca = a[i - 1];
        for (int64_t j = 1; j <= nb; ++j) {
            const int64_t sub = prev[j - 1] + (ca != b[j - 1]);
            cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
        }
        std::swap(prev, cur);
    }
    return prev[nb];
}

// Zero-pad collate: scatter variable-length float32 rows into a dense
// [batch, max_len] buffer (the data-loader hot loop of
// gigaam/utils.py:371-380).
void collate_f32(const float** rows, const int64_t* lens, int64_t batch,
                 float* out, int64_t max_len) {
    std::memset(out, 0, sizeof(float) * batch * max_len);
    for (int64_t i = 0; i < batch; ++i) {
        std::memcpy(out + i * max_len, rows[i],
                    sizeof(float) * std::min(lens[i], max_len));
    }
}

}  // extern "C"

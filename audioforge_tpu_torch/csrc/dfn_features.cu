// dfn_features: DeepFilterNet3's input features from one frame's spectrum.
//
// Replaces what XLA compiled on the TPU for the feature block of
// `models/dfn3.py _dfn_analyze` (no Pallas kernel): after the windowed
// 960-point rfft (cuFFT), per stream, the power of the 481 bins; the 32
// rectangular ERB band means (width-normalised, bands from erb_widths as
// bin offsets), 10 log10(. + 1e-10) and the exponential mean norm (alpha =
// exp(-10 ms / 1 s)), giving feat_erb = (db - mean) / 40; |X| of the 96 low
// bins, its exponential unit norm and feat_spec = X * rsqrt(max(norm,
// 1e-10)) as [2, 96] (real row, imaginary row); the new norm states.
//
// Bound: bytes, ~4.6 KB a stream (the spectrum read once, the features and
// norms written once), ~4.7 MB at fleet 1024. Design: one warp a stream, 8
// streams a block; the warp reads its spectrum as float2 (coalesced), keeps
// the power in shared memory and writes the low-bin features on the way;
// then lane b sums band b from shared memory in bin order.
#include "afk.cuh"

constexpr int DFF_FREQ = 481;
constexpr int DFF_ERB = 32;
constexpr int DFF_DF = 96;
constexpr int DFF_WARPS = 8;
constexpr int DFF_POW_STRIDE = 484;

AFK_HD float dff_rsqrt(float v) {
#ifdef __CUDA_ARCH__
    return rsqrtf(v);
#else
    return 1.0f / sqrtf(v);
#endif
}

AFK_HD float dff_power(float re, float im) { return re * re + im * im; }

// Low bin k: the new unit norm and the two features.
AFK_HD void dff_low_bin(float re, float im, float norm_in, float alpha, float one_minus,
                        float* norm_out, float* feat_re, float* feat_im) {
    const float unit = sqrtf(dff_power(re, im)) * one_minus + norm_in * alpha;
    const float scale = dff_rsqrt(fmaxf(unit, 1e-10f));
    *norm_out = unit;
    *feat_re = re * scale;
    *feat_im = im * scale;
}

// ERB band [start, end) of the power row: the new mean norm and the feature.
AFK_HD void dff_band(const float* power, int start, int end, float norm_in, float alpha,
                     float one_minus, float* norm_out, float* feat) {
    const float inv_w = 1.0f / static_cast<float>(end - start);
    float acc = 0.0f;
    for (int k = start; k < end; ++k) acc += power[k] * inv_w;
    const float db = 10.0f * log10f(acc + 1e-10f);
    const float mean = db * one_minus + norm_in * alpha;
    *norm_out = mean;
    *feat = (db - mean) / 40.0f;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(DFF_WARPS * 32)
dfn_features_kernel(const float* __restrict__ spec, const float* __restrict__ erb_norm,
                    const float* __restrict__ unit_norm, const int* __restrict__ offsets,
                    float* __restrict__ feat_erb, float* __restrict__ feat_spec,
                    float* __restrict__ erb_norm_out, float* __restrict__ unit_norm_out,
                    int N, float alpha, float one_minus) {
    __shared__ float power[DFF_WARPS * DFF_POW_STRIDE];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int n = blockIdx.x * DFF_WARPS + w;
    if (n >= N) return;
    const float2* X = reinterpret_cast<const float2*>(spec) + (long long)n * DFF_FREQ;
    float* p = power + w * DFF_POW_STRIDE;
    for (int k = lane; k < DFF_FREQ; k += 32) {
        const float2 v = X[k];
        p[k] = dff_power(v.x, v.y);
        if (k < DFF_DF) {
            const long long row = (long long)n * DFF_DF;
            dff_low_bin(v.x, v.y, unit_norm[row + k], alpha, one_minus,
                        unit_norm_out + row + k, feat_spec + 2 * row + k,
                        feat_spec + 2 * row + DFF_DF + k);
        }
    }
    __syncwarp();
    const long long row = (long long)n * DFF_ERB;
    dff_band(p, offsets[lane], offsets[lane + 1], erb_norm[row + lane], alpha, one_minus,
             erb_norm_out + row + lane, feat_erb + row + lane);
}

AFK_API int afk_dfn_features(const float* spec, const float* erb_norm,
                             const float* unit_norm, const int* offsets, float* feat_erb,
                             float* feat_spec, float* erb_norm_out, float* unit_norm_out,
                             int N, float alpha, float one_minus, void* stream) {
    const int blocks = (N + DFF_WARPS - 1) / DFF_WARPS;
    dfn_features_kernel<<<blocks, DFF_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        spec, erb_norm, unit_norm, offsets, feat_erb, feat_spec, erb_norm_out,
        unit_norm_out, N, alpha, one_minus);
    return static_cast<int>(cudaGetLastError());
}
#endif

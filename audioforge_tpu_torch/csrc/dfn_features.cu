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
// Bound: bytes, 5,768 B a stream (the spectrum [481, 2] and both norms read
// once; feat_erb, feat_spec and both norms written once), 5.9 MB at fleet
// 1024.
//
// Design: one block of 128 threads (four warps) a stream; the grid is the
// streams, so at one stream (the live engine's frame) no block waits for
// another stream. Thread t issues every load of its part of the stream
// before it uses any: bins t, t + 128, t + 256, t + 384 as float2
// (coalesced), its low bin's unit norm, its band's offsets and, on the first
// warp, the band's ERB norm. It writes the power row to shared memory and,
// on a low bin, the unit norm and both spectral features. A band's sum is
// split over the four warps: lane b of warp w sums band b's bins start + w,
// start + w + 4, ... in bin order, and lane b of warp 0 adds the parts in
// warp order, ((p0 + p1) + p2) + p3, then takes the mean power, the dB and
// the norm; the top band's 67 bins are 17 dependent adds, not 67. Timed on
// the card with compare_kernels.py (PERF.md): 64 threads a stream, two
// streams of 64 a block and one warp a stream (loads first, a lane a band)
// were as fast at fleet 1024 and slower at one stream; 256 threads a stream
// slower at fleet 1024.
#include "afk.cuh"

constexpr int DFF_FREQ = 481;
constexpr int DFF_ERB = 32;
constexpr int DFF_DF = 96;
constexpr int DFF_THREADS = 128;                  // threads a stream
constexpr int DFF_PARTS = DFF_THREADS / 32;       // warps: the parts of a band's sum
constexpr int DFF_LOADS = (DFF_FREQ + DFF_THREADS - 1) / DFF_THREADS;  // bins a thread
static_assert(DFF_THREADS >= DFF_DF, "a thread's low bin is its first bin");

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

// Part w of band [start, end): the power of bins start + w, start + w +
// DFF_PARTS, ... summed in bin order.
AFK_HD float dff_band_part(const float* power, int start, int end, int w) {
    float acc = 0.0f;
    for (int k = start + w; k < end; k += DFF_PARTS) acc += power[k];
    return acc;
}

// Band [start, end) from the sum of its parts: the new mean norm and the
// feature.
AFK_HD void dff_band(float sum, int start, int end, float norm_in, float alpha,
                     float one_minus, float* norm_out, float* feat) {
    const float mean_power = sum * (1.0f / static_cast<float>(end - start));
    const float db = 10.0f * log10f(mean_power + 1e-10f);
    const float mean = db * one_minus + norm_in * alpha;
    *norm_out = mean;
    *feat = (db - mean) / 40.0f;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(DFF_THREADS)
dfn_features_kernel(const float* __restrict__ spec, const float* __restrict__ erb_norm,
                    const float* __restrict__ unit_norm, const int* __restrict__ offsets,
                    float* __restrict__ feat_erb, float* __restrict__ feat_spec,
                    float* __restrict__ erb_norm_out, float* __restrict__ unit_norm_out,
                    float alpha, float one_minus) {
    __shared__ float power[DFF_FREQ];
    __shared__ float part[DFF_PARTS][DFF_ERB];
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const long long n = blockIdx.x;
    const float2* X = reinterpret_cast<const float2*>(spec) + n * DFF_FREQ;
    float2 v[DFF_LOADS];
#pragma unroll
    for (int j = 0; j < DFF_LOADS; ++j) {
        const int k = t + j * DFF_THREADS;
        v[j] = k < DFF_FREQ ? X[k] : make_float2(0.0f, 0.0f);
    }
    const long long low_row = n * DFF_DF;
    const float un = t < DFF_DF ? unit_norm[low_row + t] : 0.0f;
    const float en = w == 0 ? erb_norm[n * DFF_ERB + lane] : 0.0f;
    const int start = offsets[lane], end = offsets[lane + 1];
#pragma unroll
    for (int j = 0; j < DFF_LOADS; ++j) {
        const int k = t + j * DFF_THREADS;
        if (k < DFF_FREQ) power[k] = dff_power(v[j].x, v[j].y);
    }
    if (t < DFF_DF)
        dff_low_bin(v[0].x, v[0].y, un, alpha, one_minus, unit_norm_out + low_row + t,
                    feat_spec + 2 * low_row + t, feat_spec + 2 * low_row + DFF_DF + t);
    __syncthreads();
    part[w][lane] = dff_band_part(power, start, end, w);
    __syncthreads();
    if (w != 0) return;
    float sum = part[0][lane];
#pragma unroll
    for (int q = 1; q < DFF_PARTS; ++q) sum += part[q][lane];
    const long long row = n * DFF_ERB;
    dff_band(sum, start, end, en, alpha, one_minus, erb_norm_out + row + lane,
             feat_erb + row + lane);
}

AFK_API int afk_dfn_features(const float* spec, const float* erb_norm,
                             const float* unit_norm, const int* offsets, float* feat_erb,
                             float* feat_spec, float* erb_norm_out, float* unit_norm_out,
                             int N, float alpha, float one_minus, void* stream) {
    dfn_features_kernel<<<N, DFF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        spec, erb_norm, unit_norm, offsets, feat_erb, feat_spec, erb_norm_out,
        unit_norm_out, alpha, one_minus);
    return static_cast<int>(cudaGetLastError());
}
#endif

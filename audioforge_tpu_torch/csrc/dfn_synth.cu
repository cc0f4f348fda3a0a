// dfn_spec_synth: DeepFilterNet3's enhanced spectrum, before the inverse FFT.
//
// Replaces what XLA compiled on the TPU for the order-5 deep-filter FIR of
// `models/dfn3.py _dfn_analyze` and the spectral part of `_dfn_synthesize`
// (no Pallas kernel): per stream and bin, the post filter on the ERB gains
// where beta > 0 (`_post_filter`, read from the device, so no host branch),
// the rectangular ERB spread (a bin -> band table from erb_widths), Y =
// X_tgt * gain; on the 96 low bins the complex FIR of the taps df_c [5, 96, 2]
// over the raw low-bin history [5, 96, 2], which replaces them; then the
// attenuation limit applied once, Y = floor X_tgt + (1 - floor) Y with floor
// = 10^(-atten / 20). The window and overlap-add after cuFFT's irfft stay
// torch.
//
// Bound: bytes, ~15.5 KB a stream (the target spectrum, the taps and the
// history read once, the spectrum written once), ~15.8 MB at fleet 1024.
// Design: one block of 128 threads a stream; the 32 gains (post-filtered)
// staged in shared memory; each thread takes bins k, k + 128, ...: float2
// reads and writes of neighbouring bins (coalesced), the FIR's taps and
// history read per tap at stride 96 bins.
#include "afk.cuh"

constexpr int DFS_FREQ = 481;
constexpr int DFS_ERB = 32;
constexpr int DFS_DF = 96;
constexpr int DFS_ORDER = 5;
constexpr int DFS_THREADS = 128;
constexpr float DFS_HALF_PI = 1.57079637f;  // f32(0.5 * pi)

// models/dfn3.py _post_filter: g (1 + beta) / (1 + beta (g / sin(pi g / 2))^2)
AFK_HD float dfs_post_filter(float g, float beta) {
    const float ratio = g / fmaxf(sinf(DFS_HALF_PI * g), 1e-6f);
    return g * (1.0f + beta) / (1.0f + beta * (ratio * ratio));
}

struct DfsComplex {
    float re, im;
};

// The deep filter's output at low bin k: sum over taps i of c_i h_i
// (complex), taps and history laid out [order, 96, 2].
AFK_HD DfsComplex dfs_fir(const float* coefs, const float* hist, int k) {
    DfsComplex acc = {0.0f, 0.0f};
    for (int i = 0; i < DFS_ORDER; ++i) {
        const int at = 2 * (i * DFS_DF + k);
        const float cr = coefs[at], ci = coefs[at + 1];
        const float hr = hist[at], hi = hist[at + 1];
        acc.re += cr * hr - ci * hi;
        acc.im += cr * hi + ci * hr;
    }
    return acc;
}

// Bin k of the enhanced spectrum from the target bin x, its band's gain and,
// for a low bin, the deep filter's output.
AFK_HD DfsComplex dfs_bin(DfsComplex x, float gain, bool low, DfsComplex fir,
                          float floor_gain) {
    const float er = low ? fir.re : x.re * gain;
    const float ei = low ? fir.im : x.im * gain;
    return {floor_gain * x.re + (1.0f - floor_gain) * er,
            floor_gain * x.im + (1.0f - floor_gain) * ei};
}

AFK_HD float dfs_floor_gain(float atten_lim_db) { return powf(10.0f, -atten_lim_db / 20.0f); }

#ifdef __CUDACC__
__global__ void __launch_bounds__(DFS_THREADS)
dfn_spec_synth_kernel(const float* __restrict__ x_tgt, const float* __restrict__ erb_gains,
                      const float* __restrict__ coefs, const float* __restrict__ hist,
                      const int* __restrict__ bin_band, const float* __restrict__ atten_lim_db,
                      const float* __restrict__ beta, float* __restrict__ y) {
    __shared__ float gains[DFS_ERB];
    const long long n = blockIdx.x;
    if (threadIdx.x < DFS_ERB) {
        const float g = erb_gains[n * DFS_ERB + threadIdx.x];
        const float b = *beta;
        gains[threadIdx.x] = b > 0.0f ? dfs_post_filter(g, b) : g;
    }
    __syncthreads();
    const float floor_gain = dfs_floor_gain(*atten_lim_db);
    const float2* X = reinterpret_cast<const float2*>(x_tgt) + n * DFS_FREQ;
    float2* Y = reinterpret_cast<float2*>(y) + n * DFS_FREQ;
    const long long tap0 = n * DFS_ORDER * DFS_DF * 2;
    for (int k = threadIdx.x; k < DFS_FREQ; k += DFS_THREADS) {
        const float2 v = X[k];
        const bool low = k < DFS_DF;
        const DfsComplex fir = low ? dfs_fir(coefs + tap0, hist + tap0, k) : DfsComplex{};
        const DfsComplex out = dfs_bin({v.x, v.y}, gains[bin_band[k]], low, fir, floor_gain);
        Y[k] = make_float2(out.re, out.im);
    }
}

AFK_API int afk_dfn_spec_synth(const float* x_tgt, const float* erb_gains, const float* coefs,
                               const float* hist, const int* bin_band,
                               const float* atten_lim_db, const float* beta, float* y, int N,
                               void* stream) {
    dfn_spec_synth_kernel<<<N, DFS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x_tgt, erb_gains, coefs, hist, bin_band, atten_lim_db, beta, y);
    return static_cast<int>(cudaGetLastError());
}
#endif

// biquad_cascade: S crossfaded dual-lane DF2T biquad sections in series,
// one stream per thread, f64 state.
//
// Replaces the TPU path's per-section blocked associative scans
// (audioforge_tpu/ops/biquad.py:186 apply, :346 unit_process) that XLA ran for
// the EQ cascade (ops/eq.py:316), the K-weighting pair (ops/loudness.py:158),
// and the matmul form of the fixed DC blocker / 80 Hz high-pass / RNNoise
// input high-pass (ops/biquad.py:259 apply_fixed). The TPU needed double-word
// f32 for the low-frequency sections; here the state is native f64 like the
// reference's filters, and the whole cascade runs per sample in one loop, so
// a block of S sections is one launch instead of S scans.
//
// Per sample and section, each lane runs
//   y = b0*x + z1;  z1' = b1*x - a1*y + z2;  z2' = b2*x - a2*y
// and the section output blends the lanes with the crossfade weight of
// ops/biquad.py:365-371, w = clip((total - remaining + 1 + t) / total, 0, 1)
// (w = 1 when total == 0). A section whose fade is idle at block start
// (remaining == 0) has identical lanes by construction, so only lane 0 is
// computed and copied to lane 1. Promotion at block end stays in the wrapper.
//
// Layouts (stream-major): x, y [N, T] f32; coeffs [N, S, 2, 5] f32
// (b0 b1 b2 a1 a2 per lane); z [N, S, 2, 2] f64; fade_total and
// fade_remaining [N, S] int32.
//
// Bound: the f64 dependency chain (3 FMAs per lane per section per sample);
// loads of x are strided by T across a warp. Each thread's coefficients are
// staged in shared memory, interleaved by thread so a warp's reads hit
// distinct banks; the 4*S doubles of state stay in registers (S is a
// template parameter so the section loop unrolls).
#include "afk.cuh"

constexpr int AFK_BIQUAD_MAX_SECTIONS = 16;

// Coefficient k of section s, lane l sits at coeffs[((s*2 + l)*5 + k) * cs].
template <int S>
AFK_HD void biquad_cascade_stream(const float* x, float* y, int T,
                                  const float* coeffs, int cs,
                                  const double* z_in, double* z_out,
                                  const int* fade_total,
                                  const int* fade_remaining) {
    double z[S][2][2];
    bool fading[S];
    double done[S];   // total - remaining + 1
    double total[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        for (int l = 0; l < 2; ++l) {
            z[s][l][0] = z_in[(s * 2 + l) * 2 + 0];
            z[s][l][1] = z_in[(s * 2 + l) * 2 + 1];
        }
        fading[s] = fade_remaining[s] > 0;
        total[s] = (double)fade_total[s];
        done[s] = (double)(fade_total[s] - fade_remaining[s]) + 1.0;
    }
    for (int t = 0; t < T; ++t) {
        double v = (double)x[t];
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const float* c0 = coeffs + (s * 10) * cs;
            const double y0 = (double)c0[0] * v + z[s][0][0];
            z[s][0][0] = (double)c0[1 * cs] * v - (double)c0[3 * cs] * y0
                         + z[s][0][1];
            z[s][0][1] = (double)c0[2 * cs] * v - (double)c0[4 * cs] * y0;
            if (fading[s]) {
                const float* c1 = c0 + 5 * cs;
                const double y1 = (double)c1[0] * v + z[s][1][0];
                z[s][1][0] = (double)c1[1 * cs] * v - (double)c1[3 * cs] * y1
                             + z[s][1][1];
                z[s][1][1] = (double)c1[2 * cs] * v - (double)c1[4 * cs] * y1;
                double w = 1.0;
                if (total[s] > 0.0) {
                    w = (done[s] + (double)t) / fmax(total[s], 1.0);
                    w = fmin(fmax(w, 0.0), 1.0);
                }
                v = (1.0 - w) * y0 + w * y1;
            } else {
                v = y0;
            }
        }
        y[t] = (float)v;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int l1 = fading[s] ? 1 : 0;
        z_out[(s * 2 + 0) * 2 + 0] = z[s][0][0];
        z_out[(s * 2 + 0) * 2 + 1] = z[s][0][1];
        z_out[(s * 2 + 1) * 2 + 0] = z[s][l1][0];
        z_out[(s * 2 + 1) * 2 + 1] = z[s][l1][1];
    }
}

#ifdef __CUDACC__
template <int S>
__global__ void biquad_cascade_kernel(const float* __restrict__ x,
                                      const float* __restrict__ coeffs,
                                      const double* __restrict__ z_in,
                                      const int* __restrict__ fade_total,
                                      const int* __restrict__ fade_remaining,
                                      float* __restrict__ y,
                                      double* __restrict__ z_out, int N,
                                      int T) {
    extern __shared__ float sh_coeffs[];  // [S*10][blockDim.x]
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const int cs = blockDim.x;
    float* mine = sh_coeffs + threadIdx.x;
    const float* src = coeffs + (long long)n * S * 10;
    for (int k = 0; k < S * 10; ++k) mine[k * cs] = src[k];
    // each thread reads back only its own column: no block barrier needed
    biquad_cascade_stream<S>(x + (long long)n * T, y + (long long)n * T, T,
                             mine, cs, z_in + (long long)n * S * 4,
                             z_out + (long long)n * S * 4,
                             fade_total + (long long)n * S,
                             fade_remaining + (long long)n * S);
}

template <int S>
static int launch_biquad_cascade(const float* x, const float* coeffs,
                                 const double* z_in, const int* fade_total,
                                 const int* fade_remaining, float* y,
                                 double* z_out, int N, int T,
                                 cudaStream_t stream) {
    const size_t smem = sizeof(float) * S * 10 * AFK_THREADS;
    biquad_cascade_kernel<S><<<afk_blocks(N), AFK_THREADS, smem, stream>>>(
        x, coeffs, z_in, fade_total, fade_remaining, y, z_out, N, T);
    return static_cast<int>(cudaGetLastError());
}

AFK_API int afk_biquad_cascade(const float* x, const float* coeffs,
                               const double* z_in, const int* fade_total,
                               const int* fade_remaining, float* y,
                               double* z_out, int N, int S, int T,
                               void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AFK_CASE(k)                                                        \
    case k:                                                                \
        return launch_biquad_cascade<k>(x, coeffs, z_in, fade_total,       \
                                        fade_remaining, y, z_out, N, T, st);
    switch (S) {
        AFK_CASE(1) AFK_CASE(2) AFK_CASE(3) AFK_CASE(4)
        AFK_CASE(5) AFK_CASE(6) AFK_CASE(7) AFK_CASE(8)
        AFK_CASE(9) AFK_CASE(10) AFK_CASE(11) AFK_CASE(12)
        AFK_CASE(13) AFK_CASE(14) AFK_CASE(15) AFK_CASE(16)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef AFK_CASE
}
#endif

// cleanup_scan: the per-sample part of gentle/strong input cleanup, one
// stream per thread, state in registers.
//
// Replaces two pieces of the TPU path's routing_process
// (audioforge_tpu/ops/routing.py):
//   - the rumble envelope lax.scan (rumble_step, :476-514) over the raw
//     block. Its per-sample hum-hold / candidate / window-count context,
//     which the TPU built as [.., T] arrays (:461-474), is derived here from
//     the block's boundary values;
//   - the DC blocker (:534-543) and the two SmoothNotch dual-lane biquads
//     with their strength mixes (_smooth_notch_process :144, applied at
//     :621-624), which the TPU ran as compensated (double-word f32)
//     associative scans because Q 36 at 50 Hz needs the precision. Here
//     their state is native f64 and runs sequentially: the pending lane
//     starts from zero at a retune, advances only while a fade is in flight
//     and is held while idle, and the lanes blend with
//     w = clip((total - remaining + 1 + t) / total, 0, 1).
// The block-level hum analysis, the notch retune/promotion and the owned
// high-pass (a 1-section biquad_cascade launch that needs the rumble hold at
// the END of the block) stay in the wrapper.
//
// Layouts: x, y [N, T] f32 (stream-major); key-major [K, N]: fin [8, N] f32
// (CF_* rows; fout holds the first 6), coeffs [20, N] f32 (notch * 10 +
// lane * 5 + b0 b1 b2 a1 a2), z [8, N] f64 (notch * 4 + lane * 2 + z1 z2),
// iin [10, N] int32 (CI_* rows; iout holds the rumble hold).
//
// Bound: the latency of the per-sample chain (4 f64 biquad lanes at most,
// the f32 rumble envelopes, 2 divisions); x loads are strided by T across a
// warp. Built with -fmad=false (kernels/__init__.py), so the rumble
// envelopes round as the plain twin's do and the trigger's comparisons
// match it.
#include "afk.cuh"

enum {
    CF_LOWPASS, CF_LOW_ENV, CF_SLOW_LOW_ENV, CF_BROADBAND_ENV, CF_DC_X1,
    CF_DC_Y1, CF_HUM_STRENGTH, CF_HARM_STRENGTH, CF_COUNT
};
enum {
    CI_RUMBLE_HOLD, CI_BOUNDARY, CI_HOLD0, CI_HOLD_AFTER, CI_CAND0,
    CI_CAND_NEW, CI_WOBS0, CI_WOBS_NEW, CI_FADE_HUM, CI_FADE_HARM, CI_COUNT
};

struct CleanupConsts {
    float lp_c, env_thr, burst_thr;
    int rumble_hold_set, fade_total;
    double dc_coeff;
};

AFK_HD void cleanup_stream(const float* x, float* y, int T, const float* fin,
                           const float* cf, const double* zin, const int* iin,
                           float* fout, double* zout, int* iout, int ss,
                           const CleanupConsts k) {
    float lps = fin[CF_LOWPASS * ss];
    float low = fin[CF_LOW_ENV * ss];
    float slow = fin[CF_SLOW_LOW_ENV * ss];
    float broad = fin[CF_BROADBAND_ENV * ss];
    int rh = iin[CI_RUMBLE_HOLD * ss];
    const int boundary = iin[CI_BOUNDARY * ss];
    const int hold0 = iin[CI_HOLD0 * ss];
    const int hold_after = iin[CI_HOLD_AFTER * ss];
    const int cand0 = iin[CI_CAND0 * ss];
    const int cand_new = iin[CI_CAND_NEW * ss];
    const int wobs0 = iin[CI_WOBS0 * ss];
    const int wobs_new = iin[CI_WOBS_NEW * ss];

    double x1 = fin[CF_DC_X1 * ss];
    double y1 = fin[CF_DC_Y1 * ss];

    double c[2][2][5], z[2][2][2], strength[2], done[2];
    bool fading[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
        for (int l = 0; l < 2; ++l) {
            for (int j = 0; j < 5; ++j) c[n][l][j] = cf[(n * 10 + l * 5 + j) * ss];
            z[n][l][0] = zin[(n * 4 + l * 2) * ss];
            z[n][l][1] = zin[(n * 4 + l * 2 + 1) * ss];
        }
        const int remaining = iin[(CI_FADE_HUM + n) * ss];
        fading[n] = remaining > 0;
        done[n] = (double)(k.fade_total - remaining) + 1.0;
        strength[n] = afk_clip(fin[(CF_HUM_STRENGTH + n) * ss], 0.0f, 1.0f);
    }
    const double total = (double)k.fade_total;

    for (int t = 0; t < T; ++t) {
        const float xt = x[t];
        // ---- rumble detector on the raw block; window context at sample t
        const bool pre = t < boundary;
        const int hh = pre ? afk_imax(hold0 - t, 0) : afk_imax(hold_after - (t - boundary), 0);
        const int cw = pre ? cand0 : cand_new;
        const int wo = pre ? wobs0 : wobs_new;
        lps = lps + k.lp_c * (xt - lps);
        const float la = fabsf(lps);
        low = low + (la > low ? 0.08f : 0.006f) * (la - low);
        slow = slow + 0.0012f * (la - slow);
        broad = broad + 0.02f * (fabsf(xt) - broad);
        const float burst = low / fmaxf(slow, 0.006f);
        const float dom = low / fmaxf(broad, 0.01f);
        const bool startup = wo == 0 && low > 0.45f;
        const bool established = wo > 0 && slow > 0.012f;
        const bool trigger = (startup || established) && hh == 0 && cw == 0
                             && low > k.env_thr && burst > k.burst_thr
                             && dom > 0.62f;
        rh = trigger ? k.rumble_hold_set : afk_imax(rh - 1, 0);

        // ---- DC blocker, then the hum and harmonic notches with their mixes
        const double xd = (double)xt;
        double v = xd - x1 + k.dc_coeff * y1;
        x1 = xd;
        y1 = v;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            const double* c0 = c[n][0];
            const double y0 = c0[0] * v + z[n][0][0];
            z[n][0][0] = c0[1] * v - c0[3] * y0 + z[n][0][1];
            z[n][0][1] = c0[2] * v - c0[4] * y0;
            double out = y0;
            if (fading[n]) {
                const double* c1 = c[n][1];
                const double ya = c1[0] * v + z[n][1][0];
                z[n][1][0] = c1[1] * v - c1[3] * ya + z[n][1][1];
                z[n][1][1] = c1[2] * v - c1[4] * ya;
                const double w = fmin(fmax((done[n] + (double)t) / total, 0.0), 1.0);
                out = y0 + (ya - y0) * w;
            }
            v = v + (out - v) * strength[n];
        }
        y[t] = (float)v;
    }

    fout[CF_LOWPASS * ss] = lps;
    fout[CF_LOW_ENV * ss] = low;
    fout[CF_SLOW_LOW_ENV * ss] = slow;
    fout[CF_BROADBAND_ENV * ss] = broad;
    fout[CF_DC_X1 * ss] = (float)x1;
    fout[CF_DC_Y1 * ss] = (float)y1;
    iout[0] = rh;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
        for (int l = 0; l < 2; ++l) {
            zout[(n * 4 + l * 2) * ss] = z[n][l][0];
            zout[(n * 4 + l * 2 + 1) * ss] = z[n][l][1];
        }
    }
}

#ifdef __CUDACC__
__global__ void cleanup_scan_kernel(const float* __restrict__ x,
                                    const float* __restrict__ fin,
                                    const float* __restrict__ coeffs,
                                    const double* __restrict__ zin,
                                    const int* __restrict__ iin,
                                    float* __restrict__ y,
                                    float* __restrict__ fout,
                                    double* __restrict__ zout,
                                    int* __restrict__ iout, int N, int T,
                                    CleanupConsts k) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    cleanup_stream(x + (long long)n * T, y + (long long)n * T, T, fin + n,
                   coeffs + n, zin + n, iin + n, fout + n, zout + n, iout + n,
                   N, k);
}

AFK_API int afk_cleanup_scan(const float* x, const float* fin,
                             const float* coeffs, const double* zin,
                             const int* iin, float* y, float* fout,
                             double* zout, int* iout, int N, int T, float lp_c,
                             float env_thr, float burst_thr,
                             int rumble_hold_set, int fade_total,
                             double dc_coeff, void* stream) {
    const CleanupConsts k{lp_c, env_thr, burst_thr, rumble_hold_set,
                          fade_total, dc_coeff};
    cleanup_scan_kernel<<<afk_blocks(N), AFK_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        x, fin, coeffs, zin, iin, y, fout, zout, iout, N, T, k);
    return static_cast<int>(cudaGetLastError());
}
#endif

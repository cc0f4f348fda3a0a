// deesser_scan: the de-esser in one pass per sample, one stream per thread,
// the 33 state values in registers.
//
// Replaces the TPU path's three phases (audioforge_tpu/ops/deesser.py):
//   1. the 6 detector biquads, HP then LP per band (detector_filter_block,
//      :145-171), run there as parallel associative scans;
//   2. the 13-state envelope/confidence/baseline/reduction step
//      (make_envelope_step, :199-328; lax.scan at :371);
//   3. the 3 dynamic peaking biquads whose coefficients follow the band
//      reduction per sample (dynamic_peaking_coeffs :185, applied at
//      :379-385) as time-varying associative scans.
// The TPU split them only to get parallel scans; on the card one pass per
// sample keeps every filter state, envelope and coefficient in registers and
// reads x once. The gain computer (auto or manual) is a template parameter.
//
// Layouts: x, y [N, T] f32 (stream-major); state [33, N] f32 key-major
// (DS_* rows, the SCAN_STATE_KEYS order of ops/deesser.py); the constants
// arrive as a host f32 array (DeesserConsts) copied into the kernel's
// parameters at launch.
//
// Bound: the latency of the per-sample chain (9 f32 biquads, 4 log10f,
// 3 sqrtf, 3 powf and ~10 divisions per sample); x loads are strided by T
// across a warp. Built with -fmad=false (kernels/__init__.py), so every
// product and sum rounds as in the plain twin and the detector's threshold
// tests see the plain twin's values.
#include "afk.cuh"

#include <cstring>

constexpr int DS_BANDS = 3;

enum {
    DS_DET_Z = 0,        // 12 rows: band * 4 + (0 HP, 1 LP) * 2 + (z1, z2)
    DS_DYN_Z = 12,       // 6 rows: band * 2 + (z1, z2)
    DS_BAND_ENV = 18,
    DS_BAND_CONFIDENCE = 21,
    DS_BASELINE_EXCESS_DB = 24,
    DS_REDUCTION_DB = 27,
    DS_BROADBAND_ENV = 30,
    DS_CURRENT_REDUCTION_DB = 31,
    DS_DETECTOR_CONFIDENCE = 32,
    DS_ROWS = 33
};

struct DeesserConsts {
    float det[DS_BANDS][2][5];  // b0 b1 b2 a1 a2 of the HP, LP per band
    float neg2cos[DS_BANDS], alpha[DS_BANDS];
    float det_atk, det_rel, atk, rel, base_fall, base_rise, base_decay;
    float trigger_offset, slope, auto_cap, conf_floor, max_red, thr,
        ratio_thr, comp_factor;
};
constexpr int DS_CONSTS = 51;
static_assert(sizeof(DeesserConsts) == DS_CONSTS * sizeof(float),
              "DeesserConsts must match ops/deesser.py _consts");

AFK_HD float ds_smooth(float prev, float inp, float a_c, float r_c) {
    const float c = inp > prev ? a_c : r_c;
    return c * prev + (1.0f - c) * inp;
}

// DF2T: y = b0 x + z1; z1' = b1 x - a1 y + z2; z2' = b2 x - a2 y
AFK_HD float ds_df2t(const float* c, float& z1, float& z2, float x) {
    const float y = c[0] * x + z1;
    z1 = c[1] * x - c[3] * y + z2;
    z2 = c[2] * x - c[4] * y;
    return y;
}

template <bool AUTO>
AFK_HD void deesser_stream(const float* x, float* y, int T, const float* s_in,
                           float* s_out, int ss, const DeesserConsts& k) {
    float zd[DS_BANDS][2][2], zy[DS_BANDS][2];
    float env[DS_BANDS], conf[DS_BANDS], base[DS_BANDS], red[DS_BANDS];
#pragma unroll
    for (int b = 0; b < DS_BANDS; ++b) {
        for (int f = 0; f < 2; ++f) {
            zd[b][f][0] = s_in[(DS_DET_Z + b * 4 + f * 2) * ss];
            zd[b][f][1] = s_in[(DS_DET_Z + b * 4 + f * 2 + 1) * ss];
        }
        zy[b][0] = s_in[(DS_DYN_Z + b * 2) * ss];
        zy[b][1] = s_in[(DS_DYN_Z + b * 2 + 1) * ss];
        env[b] = s_in[(DS_BAND_ENV + b) * ss];
        conf[b] = s_in[(DS_BAND_CONFIDENCE + b) * ss];
        base[b] = s_in[(DS_BASELINE_EXCESS_DB + b) * ss];
        red[b] = s_in[(DS_REDUCTION_DB + b) * ss];
    }
    float broad = s_in[DS_BROADBAND_ENV * ss];
    float total_red = s_in[DS_CURRENT_REDUCTION_DB * ss];
    float agg_conf = s_in[DS_DETECTOR_CONFIDENCE * ss];

    for (int t = 0; t < T; ++t) {
        const float xt = x[t];
        // ---- phase 1: sidechain filters and envelopes
        broad = ds_smooth(broad, fabsf(xt), k.det_atk, k.det_rel);
#pragma unroll
        for (int b = 0; b < DS_BANDS; ++b) {
            const float h = ds_df2t(k.det[b][0], zd[b][0][0], zd[b][0][1], xt);
            const float side = ds_df2t(k.det[b][1], zd[b][1][0], zd[b][1][1], h);
            env[b] = ds_smooth(env[b], fabsf(side), k.det_atk, k.det_rel);
        }
        // ---- phase 2: confidence and gain computer
        const float total_env = env[0] + env[1] + env[2];
        const float max_env = fmaxf(fmaxf(env[0], env[1]), env[2]);
        const float voice_db = afk_linear_to_db(
            fmaxf(broad - total_env * 0.6f, 1e-8f), -200.0f);
        const float narrowness =
            total_env > 1e-10f ? max_env / fmaxf(total_env, 1e-30f) : 0.0f;
        const float voice_conf = afk_clip((voice_db + 58.0f) / 24.0f, 0.0f, 1.0f);
        const float narrow_gain =
            0.35f + 0.65f * afk_clip((narrowness - 0.34f) / 0.34f, 0.0f, 1.0f);
        float target[DS_BANDS];
#pragma unroll
        for (int b = 0; b < DS_BANDS; ++b) {
            const float band_db = afk_linear_to_db(fmaxf(env[b], 1e-10f), -200.0f);
            const float ratio = fmaxf(band_db - voice_db, 0.0f);
            const float dominance =
                max_env > 1e-10f ? sqrtf(env[b] / fmaxf(max_env, 1e-30f)) : 0.0f;
            const float ratio_conf = afk_clip((ratio - 1.5f) / 8.5f, 0.0f, 1.0f);
            const float level_conf = afk_clip((band_db + 62.0f) / 38.0f, 0.0f, 1.0f);
            const float narrow_support =
                (ratio > 6.0f && band_db > -45.0f) ? 0.75f : 0.0f;
            const float voice_support = fmaxf(voice_conf, narrow_support);
            const float balance = ratio_conf > 0.12f
                                      ? fmaxf(ratio_conf, voice_support * 0.65f)
                                      : ratio_conf;
            const float penalty = 0.35f + 0.65f * balance;
            const float conf_target =
                ((0.62f * ratio_conf + 0.18f * level_conf + 0.20f * voice_support)
                 * penalty * narrow_gain) * dominance;
            conf[b] = ds_smooth(conf[b], afk_clip(conf_target, 0.0f, 1.0f),
                                k.det_atk, k.det_rel);
            if (AUTO) {
                const bool voice_active = voice_db > -55.0f || band_db > -55.0f;
                const float base_target = afk_clip(ratio * 0.45f, 0.0f, 24.0f);
                const float bc = base_target < base[b] ? k.base_fall : k.base_rise;
                const float active = bc * base[b] + (1.0f - bc) * base_target;
                base[b] = voice_active ? active : base[b] * k.base_decay;
                const float conf_gain = afk_clip(
                    (conf[b] - k.conf_floor) / (1.0f - k.conf_floor), 0.0f, 1.0f);
                const float over = fmaxf(ratio - base[b] - k.trigger_offset, 0.0f);
                target[b] = afk_clip(over * k.slope * conf_gain, 0.0f, k.auto_cap);
            } else {
                const float conf_gain =
                    afk_clip((conf[b] - 0.22f) / 0.78f, 0.0f, 1.0f);
                const float ratio_over = ratio - k.ratio_thr;
                const float over = fminf(band_db - k.thr, ratio_over);
                target[b] = (band_db > k.thr && ratio_over > 0.0f)
                                ? afk_clip(k.comp_factor * over * conf_gain, 0.0f,
                                           k.max_red * 0.75f)
                                : 0.0f;
            }
        }
        const float total_target = target[0] + target[1] + target[2];
        const float scale = total_target > fmaxf(k.max_red, 0.0f)
                                ? k.max_red / fmaxf(total_target, 1e-30f)
                                : 1.0f;
#pragma unroll
        for (int b = 0; b < DS_BANDS; ++b)
            red[b] = ds_smooth(red[b], target[b] * scale, k.atk, k.rel);
        total_red = fminf(red[0] + red[1] + red[2], k.max_red);
        agg_conf = afk_clip(fmaxf(fmaxf(conf[0], conf[1]), conf[2]), 0.0f, 1.0f);

        // ---- phase 3: dynamic peaking bands, gain from this sample's reduction
        float v = xt;
#pragma unroll
        for (int b = 0; b < DS_BANDS; ++b) {
            const float A = powf(10.0f, -red[b] / 40.0f);
            const float a0 = 1.0f + k.alpha[b] / A;
            const float c[5] = {(1.0f + k.alpha[b] * A) / a0, k.neg2cos[b] / a0,
                                (1.0f - k.alpha[b] * A) / a0, k.neg2cos[b] / a0,
                                (1.0f - k.alpha[b] / A) / a0};
            v = ds_df2t(c, zy[b][0], zy[b][1], v);
        }
        y[t] = v;
    }

#pragma unroll
    for (int b = 0; b < DS_BANDS; ++b) {
        for (int f = 0; f < 2; ++f) {
            s_out[(DS_DET_Z + b * 4 + f * 2) * ss] = zd[b][f][0];
            s_out[(DS_DET_Z + b * 4 + f * 2 + 1) * ss] = zd[b][f][1];
        }
        s_out[(DS_DYN_Z + b * 2) * ss] = zy[b][0];
        s_out[(DS_DYN_Z + b * 2 + 1) * ss] = zy[b][1];
        s_out[(DS_BAND_ENV + b) * ss] = env[b];
        s_out[(DS_BAND_CONFIDENCE + b) * ss] = conf[b];
        s_out[(DS_BASELINE_EXCESS_DB + b) * ss] = base[b];
        s_out[(DS_REDUCTION_DB + b) * ss] = red[b];
    }
    s_out[DS_BROADBAND_ENV * ss] = broad;
    s_out[DS_CURRENT_REDUCTION_DB * ss] = total_red;
    s_out[DS_DETECTOR_CONFIDENCE * ss] = agg_conf;
}

#ifdef __CUDACC__
template <bool AUTO>
__global__ void deesser_scan_kernel(const float* __restrict__ x,
                                    const float* __restrict__ s_in,
                                    float* __restrict__ y,
                                    float* __restrict__ s_out, int N, int T,
                                    DeesserConsts k) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    deesser_stream<AUTO>(x + (long long)n * T, y + (long long)n * T, T,
                         s_in + n, s_out + n, N, k);
}

AFK_API int afk_deesser_scan(const float* x, const float* s_in, float* y,
                             float* s_out, int N, int T,
                             const float* host_consts, int n_consts,
                             int auto_mode, void* stream) {
    if (n_consts != DS_CONSTS) return static_cast<int>(cudaErrorInvalidValue);
    DeesserConsts k;
    std::memcpy(&k, host_consts, sizeof(k));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (auto_mode) {
        deesser_scan_kernel<true><<<afk_blocks(N), AFK_THREADS, 0, st>>>(
            x, s_in, y, s_out, N, T, k);
    } else {
        deesser_scan_kernel<false><<<afk_blocks(N), AFK_THREADS, 0, st>>>(
            x, s_in, y, s_out, N, T, k);
    }
    return static_cast<int>(cudaGetLastError());
}
#endif

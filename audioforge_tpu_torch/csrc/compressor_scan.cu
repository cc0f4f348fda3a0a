// compressor_scan: the compressor's per-sample recurrence, one stream per
// thread, state in registers.
//
// Replaces the TPU path's lax.scan of `make_sample_step`
// (audioforge_tpu/ops/compressor.py:277-421, scanned at :577), line by line:
// sidechain 120 Hz one-pole high-pass and three-band plosive weighting,
// 0.6 peak + 0.4 RMS blended detector, soft-knee static curve, optional
// adaptive fast/slow release, GR smoothing and makeup. The block-cadence
// auto makeup (finalize_block, :422) stays in PyTorch.
//
// Layouts: x, y [N, T] f32 (stream-major); params [P, N] f32 and the scan
// state [K, N] f32 are key-major so a warp's state loads are coalesced.
// Param rows: threshold_db, ratio, attack_coeff, detector_release_coeff,
// base_release_ms, knee_db, sidechain_hp_coeff, makeup_lin.
// State rows: the COMP_STATE_KEYS order of ops/compressor.py.
//
// Bound: the latency of the per-sample dependency chain (~40 f32 ops with
// log10f/powf/sqrtf); x loads are strided by T across a warp.
#include "afk.cuh"

enum {
    P_THRESHOLD_DB, P_RATIO, P_ATTACK_COEFF, P_DETECTOR_RELEASE_COEFF,
    P_BASE_RELEASE_MS, P_KNEE_DB, P_SIDECHAIN_HP_COEFF, P_MAKEUP_LIN,
    P_COUNT
};

enum {
    S_PEAK_ENVELOPE_DB, S_RMS_ENVELOPE_SQ, S_CURRENT_GR_DB,
    S_FAST_RELEASE_ENV_DB, S_SLOW_RELEASE_ENV_DB, S_CURRENT_RELEASE_MS,
    S_SC_PREV_IN, S_SC_PREV_OUT, S_LOW_BAND_ENV_SQ, S_VOICED_BAND_ENV_SQ,
    S_PRESENCE_BAND_ENV_SQ, S_PLOSIVE_RATIO, S_COUNT
};

struct CompressorConsts {
    float rms_c, band_c, rel_smooth_c, fast_c, charge_c, slow_c, fs;
    int adaptive_release, sidechain_hp;
};

// ops/compressor.py:251 _compute_gain_reduction
AFK_HD float comp_gain_reduction(float det_db, float thr, float ratio,
                                 float knee) {
    const float comp = 1.0f - 1.0f / ratio;
    const float hard = det_db <= thr ? 0.0f : (det_db - thr) * comp;
    const float half = knee / 2.0f;
    const float xk = det_db - (thr - half);
    float soft;
    if (det_db <= thr - half) {
        soft = 0.0f;
    } else if (det_db >= thr + half) {
        soft = (det_db - thr) * comp;
    } else {
        soft = comp * xk * xk / (2.0f * fmaxf(knee, 1e-9f));
    }
    return knee <= 0.0f ? hard : soft;
}

// p[k * ps] is param k of this stream; s_in[k * ss] / s_out[k * ss] state k.
AFK_HD void compressor_stream(const float* x, float* y, int T, const float* p,
                              int ps, const float* s_in, float* s_out, int ss,
                              const CompressorConsts k) {
    const float thr = p[P_THRESHOLD_DB * ps];
    const float ratio = p[P_RATIO * ps];
    const float atk = p[P_ATTACK_COEFF * ps];
    const float det_rel = p[P_DETECTOR_RELEASE_COEFF * ps];
    const float base_rel_ms = p[P_BASE_RELEASE_MS * ps];
    const float knee = p[P_KNEE_DB * ps];
    const float hp_c = p[P_SIDECHAIN_HP_COEFF * ps];
    const float makeup_lin = p[P_MAKEUP_LIN * ps];

    float peak_env = s_in[S_PEAK_ENVELOPE_DB * ss];
    float rms_env = s_in[S_RMS_ENVELOPE_SQ * ss];
    float cur_gr = s_in[S_CURRENT_GR_DB * ss];
    float fast_env = s_in[S_FAST_RELEASE_ENV_DB * ss];
    float slow_env = s_in[S_SLOW_RELEASE_ENV_DB * ss];
    float cur_rel_ms = s_in[S_CURRENT_RELEASE_MS * ss];
    float sc_in = s_in[S_SC_PREV_IN * ss];
    float sc_out = s_in[S_SC_PREV_OUT * ss];
    float low_env = s_in[S_LOW_BAND_ENV_SQ * ss];
    float voiced_env = s_in[S_VOICED_BAND_ENV_SQ * ss];
    float pres_env = s_in[S_PRESENCE_BAND_ENV_SQ * ss];
    float plosive_ratio = s_in[S_PLOSIVE_RATIO * ss];

    for (int t = 0; t < T; ++t) {
        const float xt = x[t];
        // ---- sidechain high-pass + 3-band plosive metrics
        float det_in, det_weight;
        if (k.sidechain_hp) {
            det_in = hp_c * (sc_out + xt - sc_in);
            sc_in = xt;
            sc_out = det_in;
            const float low_c = xt - det_in;
            const float voiced_c = det_in;
            const float presence_c = 0.65f * det_in + 0.35f * (det_in - low_c);
            low_env = k.band_c * low_env + (1.0f - k.band_c) * low_c * low_c;
            voiced_env = k.band_c * voiced_env
                         + (1.0f - k.band_c) * voiced_c * voiced_c;
            pres_env = k.band_c * pres_env
                       + (1.0f - k.band_c) * presence_c * presence_c;
            const float low_rms = sqrtf(low_env);
            const float voiced_rms = fmaxf(sqrtf(voiced_env), 1e-8f);
            const float pres_rms = sqrtf(pres_env);
            plosive_ratio = afk_clip(low_rms / voiced_rms, 0.0f, 32.0f);
            const float amount =
                afk_clip((plosive_ratio - 1.25f) / 3.75f, 0.0f, 1.0f);
            const float penalty = 1.0f - amount * 0.65f;
            const float pres_ratio = afk_clip(pres_rms / voiced_rms, 0.0f, 4.0f);
            const float pres_weight =
                1.0f + 0.18f * afk_clip(pres_ratio - 0.75f, 0.0f, 1.0f);
            det_weight = afk_clip(penalty * pres_weight, 0.35f, 1.15f);
        } else {
            det_in = xt;
            plosive_ratio = 0.0f;
            det_weight = 1.0f;
        }

        // ---- detectors
        const float inst_peak_db =
            afk_linear_to_db(fmaxf(fabsf(det_in), 1e-10f), -200.0f);
        const float peak_c = inst_peak_db > peak_env ? atk : det_rel;
        peak_env = peak_c * peak_env + (1.0f - peak_c) * inst_peak_db;
        rms_env = k.rms_c * rms_env + (1.0f - k.rms_c) * det_in * det_in;
        const float blended = 0.6f * powf(10.0f, peak_env / 20.0f)
                              + 0.4f * fmaxf(sqrtf(rms_env), 1e-10f);
        const float detector_db = afk_linear_to_db(
            fmaxf(blended, 1e-10f) * fmaxf(det_weight, 1e-10f), -200.0f);

        // ---- adaptive release meter
        float target_rel_ms;
        if (k.adaptive_release) {
            const float sustained = afk_clip(slow_env / 6.0f, 0.0f, 1.0f);
            const float transient =
                afk_clip((fast_env - slow_env) / 7.0f, 0.0f, 1.0f);
            const float syllabic = afk_clip(
                sustained * sustained * (1.0f - 0.35f * transient), 0.0f, 1.0f);
            target_rel_ms = 50.0f + syllabic * 350.0f;
        } else {
            target_rel_ms = base_rel_ms;
        }
        const float diff = target_rel_ms - cur_rel_ms;
        cur_rel_ms = fabsf(diff) > 1.0f
                         ? k.rel_smooth_c * cur_rel_ms
                               + (1.0f - k.rel_smooth_c) * target_rel_ms
                         : target_rel_ms;
        const float rx = -1000.0f / (fmaxf(cur_rel_ms, 1e-6f) * k.fs);
        const float rel_c = 1.0f + rx + 0.5f * rx * rx;

        // ---- static curve + GR smoothing
        const float target_gr = comp_gain_reduction(detector_db, thr, ratio, knee);
        if (k.adaptive_release) {
            fast_env = target_gr > cur_gr
                           ? atk * cur_gr + (1.0f - atk) * target_gr
                           : k.fast_c * fast_env + (1.0f - k.fast_c) * target_gr;
            slow_env = target_gr > 3.0f
                           ? k.charge_c * slow_env + (1.0f - k.charge_c) * target_gr
                           : k.slow_c * slow_env;
            cur_gr = fmaxf(fast_env, slow_env);
        } else {
            const float gr_c = target_gr > cur_gr ? atk : rel_c;
            cur_gr = gr_c * cur_gr + (1.0f - gr_c) * target_gr;
            fast_env = cur_gr;
            slow_env = 0.0f;
        }
        y[t] = xt * powf(10.0f, -cur_gr / 20.0f) * makeup_lin;
    }

    s_out[S_PEAK_ENVELOPE_DB * ss] = peak_env;
    s_out[S_RMS_ENVELOPE_SQ * ss] = rms_env;
    s_out[S_CURRENT_GR_DB * ss] = cur_gr;
    s_out[S_FAST_RELEASE_ENV_DB * ss] = fast_env;
    s_out[S_SLOW_RELEASE_ENV_DB * ss] = slow_env;
    s_out[S_CURRENT_RELEASE_MS * ss] = cur_rel_ms;
    s_out[S_SC_PREV_IN * ss] = sc_in;
    s_out[S_SC_PREV_OUT * ss] = sc_out;
    s_out[S_LOW_BAND_ENV_SQ * ss] = low_env;
    s_out[S_VOICED_BAND_ENV_SQ * ss] = voiced_env;
    s_out[S_PRESENCE_BAND_ENV_SQ * ss] = pres_env;
    s_out[S_PLOSIVE_RATIO * ss] = plosive_ratio;
}

#ifdef __CUDACC__
__global__ void compressor_scan_kernel(const float* __restrict__ x,
                                       const float* __restrict__ params,
                                       const float* __restrict__ state_in,
                                       float* __restrict__ y,
                                       float* __restrict__ state_out, int N,
                                       int T, CompressorConsts k) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    compressor_stream(x + (long long)n * T, y + (long long)n * T, T,
                      params + n, N, state_in + n, state_out + n, N, k);
}

AFK_API int afk_compressor_scan(const float* x, const float* params,
                                const float* state_in, float* y,
                                float* state_out, int N, int T, float rms_c,
                                float band_c, float rel_smooth_c, float fast_c,
                                float charge_c, float slow_c, float fs,
                                int adaptive_release, int sidechain_hp,
                                void* stream) {
    const CompressorConsts k{rms_c,  band_c, rel_smooth_c,     fast_c,
                             charge_c, slow_c, fs, adaptive_release,
                             sidechain_hp};
    compressor_scan_kernel<<<afk_blocks(N), AFK_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        x, params, state_in, y, state_out, N, T, k);
    return static_cast<int>(cudaGetLastError());
}
#endif

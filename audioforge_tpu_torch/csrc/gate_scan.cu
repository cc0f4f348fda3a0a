// gate_scan: the smart gate's per-sample recurrence (downward expander with
// VAD fusion, chatter tracking and gain smoothing), one stream per thread,
// the 18 state values in registers.
//
// Replaces the TPU path's lax.scan of the gate step
// (audioforge_tpu/ops/gate.py:233-456, scanned at :458) and the port's own
// per-sample PyTorch loop (ops/gate.py gate_process_plain), line by line:
// RMS detector with hold and hysteresis, level score, VAD-fused score and the
// five-state probability machine (VAD modes), chatter window/cooldown with
// auto-relax, target gain reduction and attack/release gain smoothing. The
// mode (threshold-only, VAD-assisted, VAD-only) is a template parameter.
//
// Layouts: x, y [N, T] f32 (stream-major). Key-major [K, N] so a warp's
// loads are coalesced: params [3, N] f32 (threshold_db, attack_coeff,
// release_coeff); VAD inputs [4, N] f32 (probability, available 0/1, held
// 0/1, threshold); float state [7, N] f32 and integer state [11, N] int32
// (booleans as 0/1) in the GATE_FLOAT_KEYS / GATE_INT_KEYS order of
// ops/gate.py.
//
// Bound: the latency of the per-sample dependency chain (log10f, powf and a
// few dozen compares and selects per sample); x loads are strided by T
// across a warp. Built with -fmad=false (kernels/__init__.py): every product
// and sum rounds on its own, as the plain twin's elementwise ops round them,
// so the level that meets the >= threshold test is the plain twin's to the
// bit.
#include "afk.cuh"

enum { GATE_THRESHOLD_ONLY = 0, GATE_VAD_ASSISTED = 1, GATE_VAD_ONLY = 2 };

enum { GP_THRESHOLD_DB, GP_ATTACK_COEFF, GP_RELEASE_COEFF, GP_COUNT };
enum { GV_PROBABILITY, GV_AVAILABLE, GV_HELD, GV_THRESHOLD, GV_COUNT };
enum {
    GF_RMS_ENVELOPE_SQ, GF_DETECTOR_LEVEL_DB, GF_CURRENT_GAIN,
    GF_FUSED_GATE_SCORE, GF_VAD_SMOOTHED_PROBABILITY,
    GF_PREVIOUS_VAD_PROBABILITY, GF_PEAK_LEVEL, GF_COUNT
};
enum {
    GI_HOLD_REMAINING, GI_IS_OPEN, GI_EFFECTIVE_GATE_OPEN,
    GI_HAS_EFFECTIVE_GATE_STATE, GI_CHATTER_WINDOW_REMAINING,
    GI_CHATTER_TRANSITION_COUNT, GI_CHATTER_COOLDOWN, GI_CHATTER_EVENT_COUNT,
    GI_GATE_STATE, GI_FUSED_GATE_OPEN, GI_AUTO_RELAX_REMAINING, GI_COUNT
};
enum { G_CLOSED, G_OPENING, G_OPEN, G_UNCERTAIN, G_RELEASING };

struct GateConsts {
    float rms_c, rms_1, sm_c, sm_1;
    int hold_samples, chatter_window, chatter_cooldown, auto_relax_samples;
};

// p[k * ss], v[k * ss], fs_*[k * ss], is_*[k * ss]: row k of this stream.
template <int MODE>
AFK_HD void gate_stream(const float* x, float* y, int T, const float* p,
                        const float* v, const float* fs_in, float* fs_out,
                        const int* is_in, int* is_out, int ss,
                        const GateConsts k) {
    const float thr = p[GP_THRESHOLD_DB * ss];
    const float atk = p[GP_ATTACK_COEFF * ss];
    const float rel = p[GP_RELEASE_COEFF * ss];

    float rms_env = fs_in[GF_RMS_ENVELOPE_SQ * ss];
    float level_db = fs_in[GF_DETECTOR_LEVEL_DB * ss];
    float gain = fs_in[GF_CURRENT_GAIN * ss];
    float fused_score = fs_in[GF_FUSED_GATE_SCORE * ss];
    float smoothed = fs_in[GF_VAD_SMOOTHED_PROBABILITY * ss];
    float prev_prob = fs_in[GF_PREVIOUS_VAD_PROBABILITY * ss];
    float peak = fs_in[GF_PEAK_LEVEL * ss];
    int hold = is_in[GI_HOLD_REMAINING * ss];
    bool is_open = is_in[GI_IS_OPEN * ss] != 0;
    bool eff_open = is_in[GI_EFFECTIVE_GATE_OPEN * ss] != 0;
    bool has_eff = is_in[GI_HAS_EFFECTIVE_GATE_STATE * ss] != 0;
    int win_rem = is_in[GI_CHATTER_WINDOW_REMAINING * ss];
    int cnt = is_in[GI_CHATTER_TRANSITION_COUNT * ss];
    int cooldown = is_in[GI_CHATTER_COOLDOWN * ss];
    int events = is_in[GI_CHATTER_EVENT_COUNT * ss];
    int gs = is_in[GI_GATE_STATE * ss];
    bool fused_open = is_in[GI_FUSED_GATE_OPEN * ss] != 0;
    int relax_rem = is_in[GI_AUTO_RELAX_REMAINING * ss];

    // block-constant VAD terms (ops/gate.py:117-130)
    float prob = 0.0f, vad_score = 0.0f, open_thr = 0.0f, c_close = 0.0f;
    float span = 1.0f, prob_delta = 0.0f, scale = 0.0f;
    bool avail = false, held = false;
    if (MODE != GATE_THRESHOLD_ONLY) {
        prob = v[GV_PROBABILITY * ss];
        avail = v[GV_AVAILABLE * ss] != 0.0f;
        held = v[GV_HELD * ss] != 0.0f;
        open_thr = afk_clip(v[GV_THRESHOLD * ss], 0.05f, 0.95f);
        prob_delta = prob - prev_prob;
        vad_score = afk_clip(prob, 0.0f, 1.0f);
        c_close = fminf(fmaxf(open_thr - 0.20f, 0.02f),
                        fmaxf(open_thr - 0.02f, 0.02f));
        span = fmaxf(open_thr - c_close, 1e-3f);
        scale = MODE == GATE_VAD_ASSISTED ? 0.30f : 0.45f;
    }

    for (int t = 0; t < T; ++t) {
        const float xt = x[t];
        // ---- detector
        rms_env = k.rms_c * rms_env + k.rms_1 * xt * xt;
        level_db = afk_linear_to_db(fmaxf(sqrtf(rms_env), 1e-10f), -200.0f);
        const bool above = level_db >= thr;
        const bool holding = !above && hold > 0;
        hold = above ? k.hold_samples : afk_imax(hold - 1, 0);
        const bool below_hyst = level_db <= thr - 4.0f;
        is_open = above || holding || (!below_hyst && is_open);
        peak = fmaxf(peak, level_db);

        const bool auto_relax = relax_rem > 0;
        const float range_db = auto_relax ? 24.0f : 36.0f;
        const float closed_db = thr - 4.0f;
        const float level_score = afk_clip((level_db - closed_db) / 4.0f, 0.0f, 1.0f);
        const float detector_gr =
            is_open ? 0.0f
                    : fminf(fmaxf((thr - level_db) * 0.75f, 0.0f), range_db);
        const float gain_prev = gain;

        float target_gr;
        bool effective_open;
        if (MODE != GATE_THRESHOLD_ONLY) {
            smoothed = afk_clip(k.sm_c * smoothed + k.sm_1 * prob, 0.0f, 1.0f);
            const float recent = (fused_open || gain_prev > 0.35f) ? 1.0f : 0.0f;
            if (MODE == GATE_VAD_ASSISTED) {
                const float blended = afk_clip(
                    0.55f * level_score + 0.45f * vad_score + 0.10f * recent,
                    0.0f, 1.0f);
                fused_score = avail ? fmaxf(fmaxf(level_score, vad_score), blended)
                                    : 0.85f * level_score + 0.15f * recent;
            } else {
                fused_score = avail ? (held ? fmaxf(vad_score, 0.55f) : vad_score)
                                    : (held ? 0.55f : 0.0f);
            }
            fused_open = fused_score >= 0.55f || (fused_score > 0.35f && fused_open);

            const float close_margin = auto_relax ? 0.20f : 0.12f;
            const float close_thr =
                fminf(fmaxf(open_thr - close_margin, 0.02f), open_thr);
            const bool vad_open =
                avail && (prob >= open_thr
                          || (prob_delta >= 0.08f && prob >= close_thr));
            const bool vad_uncertain = avail && prob >= close_thr;
            const bool level_open = is_open || level_score >= 0.55f;
            const bool level_uncertain = level_score >= 0.22f || gain_prev > 0.12f;
            const bool cand_ok = !avail || vad_uncertain || gain_prev > 0.20f;
            bool strong_open, sustain;
            if (MODE == GATE_VAD_ASSISTED) {
                strong_open = (level_open && cand_ok) || (fused_open && cand_ok)
                              || (held && cand_ok) || vad_open;
                sustain = strong_open || vad_uncertain || level_uncertain
                          || (auto_relax && level_score > 0.08f);
            } else {
                strong_open = held || vad_open;
                sustain = strong_open || vad_uncertain
                          || (auto_relax && gain_prev > 0.12f);
            }
            const bool releasing_sustain =
                sustain || (gain_prev > 0.20f && (vad_uncertain || auto_relax));
            const int fallback = sustain ? G_UNCERTAIN
                                 : (releasing_sustain ? G_RELEASING : G_CLOSED);
            if (gs == G_CLOSED) {
                gs = strong_open ? G_OPENING : G_CLOSED;
            } else if (gs == G_OPENING) {
                gs = strong_open ? G_OPEN : (sustain ? G_UNCERTAIN : G_CLOSED);
            } else if (gs == G_OPEN) {
                gs = strong_open ? G_OPEN : fallback;
            } else {
                gs = strong_open ? G_OPENING : fallback;
            }
            const bool prob_open = gs != G_CLOSED;
            const float normalized =
                afk_clip((smoothed - c_close) / span, 0.0f, 1.0f);
            float closure =
                1.0f - normalized * normalized * (3.0f - 2.0f * normalized);
            if (held && smoothed >= open_thr - 0.20f) closure = fminf(closure, 0.80f);
            const float posterior_gr = avail ? range_db * closure * scale : 0.0f;
            target_gr = !prob_open ? range_db : fmaxf(detector_gr, posterior_gr);
            effective_open = prob_open;
        } else {
            fused_score = level_score;
            target_gr = detector_gr;
            effective_open = is_open;
        }

        // ---- chatter tracking
        const bool first = !has_eff;
        const bool transitioned = !first && effective_open != eff_open;
        int win = win_rem;
        if (transitioned) {
            cnt = win_rem == 0 ? 1 : cnt + 1;
            if (win_rem == 0) win = k.chatter_window;
        }
        const bool chatter_fire =
            transitioned && cnt >= 4 && cooldown == 0;
        events += chatter_fire ? 1 : 0;
        if (chatter_fire) {
            cooldown = k.chatter_cooldown;
            if (MODE != GATE_THRESHOLD_ONLY) relax_rem = k.auto_relax_samples;
            win = 0;
            cnt = 0;
        }
        relax_rem = afk_imax(relax_rem - 1, 0);
        win_rem = afk_imax(win - 1, 0);
        if (win > 0 && win_rem == 0) cnt = 0;
        cooldown = afk_imax(cooldown - 1, 0);
        if (first || transitioned) eff_open = effective_open;
        has_eff = true;

        // ---- gain smoothing
        const float target_gain = powf(10.0f, -target_gr / 20.0f);
        const float c = target_gain > gain_prev ? atk : rel;
        gain = c * gain_prev + (1.0f - c) * target_gain;
        y[t] = xt * gain;
    }
    if (MODE != GATE_THRESHOLD_ONLY) prev_prob = prob;

    fs_out[GF_RMS_ENVELOPE_SQ * ss] = rms_env;
    fs_out[GF_DETECTOR_LEVEL_DB * ss] = level_db;
    fs_out[GF_CURRENT_GAIN * ss] = gain;
    fs_out[GF_FUSED_GATE_SCORE * ss] = fused_score;
    fs_out[GF_VAD_SMOOTHED_PROBABILITY * ss] = smoothed;
    fs_out[GF_PREVIOUS_VAD_PROBABILITY * ss] = prev_prob;
    fs_out[GF_PEAK_LEVEL * ss] = peak;
    is_out[GI_HOLD_REMAINING * ss] = hold;
    is_out[GI_IS_OPEN * ss] = is_open;
    is_out[GI_EFFECTIVE_GATE_OPEN * ss] = eff_open;
    is_out[GI_HAS_EFFECTIVE_GATE_STATE * ss] = has_eff;
    is_out[GI_CHATTER_WINDOW_REMAINING * ss] = win_rem;
    is_out[GI_CHATTER_TRANSITION_COUNT * ss] = cnt;
    is_out[GI_CHATTER_COOLDOWN * ss] = cooldown;
    is_out[GI_CHATTER_EVENT_COUNT * ss] = events;
    is_out[GI_GATE_STATE * ss] = gs;
    is_out[GI_FUSED_GATE_OPEN * ss] = fused_open;
    is_out[GI_AUTO_RELAX_REMAINING * ss] = relax_rem;
}

#ifdef __CUDACC__
template <int MODE>
__global__ void gate_scan_kernel(const float* __restrict__ x,
                                 const float* __restrict__ params,
                                 const float* __restrict__ vad,
                                 const float* __restrict__ fs_in,
                                 const int* __restrict__ is_in,
                                 float* __restrict__ y,
                                 float* __restrict__ fs_out,
                                 int* __restrict__ is_out, int N, int T,
                                 GateConsts k) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    gate_stream<MODE>(x + (long long)n * T, y + (long long)n * T, T,
                      params + n, vad + n, fs_in + n, fs_out + n, is_in + n,
                      is_out + n, N, k);
}

AFK_API int afk_gate_scan(const float* x, const float* params,
                          const float* vad, const float* fs_in,
                          const int* is_in, float* y, float* fs_out,
                          int* is_out, int N, int T, int mode, float rms_c,
                          float rms_1, float sm_c, float sm_1,
                          int hold_samples, int chatter_window,
                          int chatter_cooldown, int auto_relax_samples,
                          void* stream) {
    const GateConsts k{rms_c, rms_1, sm_c, sm_1, hold_samples, chatter_window,
                       chatter_cooldown, auto_relax_samples};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case GATE_THRESHOLD_ONLY:
            gate_scan_kernel<GATE_THRESHOLD_ONLY><<<afk_blocks(N), AFK_THREADS, 0, st>>>(
                x, params, vad, fs_in, is_in, y, fs_out, is_out, N, T, k);
            break;
        case GATE_VAD_ASSISTED:
            gate_scan_kernel<GATE_VAD_ASSISTED><<<afk_blocks(N), AFK_THREADS, 0, st>>>(
                x, params, vad, fs_in, is_in, y, fs_out, is_out, N, T, k);
            break;
        case GATE_VAD_ONLY:
            gate_scan_kernel<GATE_VAD_ONLY><<<afk_blocks(N), AFK_THREADS, 0, st>>>(
                x, params, vad, fs_in, is_in, y, fs_out, is_out, N, T, k);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
#endif

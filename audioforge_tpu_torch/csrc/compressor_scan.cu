// compressor_scan: the compressor's per-sample step, its recurrences serial on
// a lane each and its feed-forward math spread over the block's samples, over
// a shared-memory tile of the block.
//
// Replaces the TPU path's lax.scan of `make_sample_step`
// (audioforge_tpu/ops/compressor.py:277-421, scanned at :577): sidechain
// 120 Hz one-pole high-pass and three-band plosive weighting, 0.6 peak + 0.4
// RMS blended detector, soft-knee static curve, optional adaptive fast/slow
// release, GR smoothing and makeup. The block-cadence auto makeup
// (finalize_block, :422) stays in PyTorch. The sidechain high-pass and the
// adaptive release are template parameters (four instantiations).
//
// Layouts: x, y [N, T] f32 (stream-major); params [P, N] f32 and the scan
// state [K, N] f32 are key-major. Param rows: threshold_db, ratio,
// attack_coeff, detector_release_coeff, base_release_ms, knee_db,
// sidechain_hp_coeff, makeup_lin. State rows: the SCAN_STATE_KEYS order of
// ops/compressor.py.
//
// Design. Of the per-sample step only eight values carry from one sample to
// the next: the high-pass, the three band envelopes, the RMS and peak
// envelopes, the release time, and the gain reduction (with its fast and slow
// envelopes on the adaptive path). The rest (three sqrtf and two divisions of
// the plosive weighting, two log10f, powf and sqrtf of the detector, the
// static curve's divisions, the release coefficient's division, the output's
// powf) depends on the carried values of the same sample only. A serial phase
// is one warp stepping through the chunk in order, so its time is its
// instructions per step: whatever a step adds that does not depend on the
// carried value (an envelope's (1 - c) w w, both terms an attack/release
// select picks from) is formed by the parallel phase before it. A block owns
// CS_STREAMS streams and sixteen warps, stages its rows of x in shared memory
// (afk_tile_load; chunked over T where the tile would not fit), keeps the
// streams' state and parameters in shared memory too, and runs each chunk in
// phases with a block barrier between them:
//   A  serial, one lane per stream: the sidechain high-pass -> DET row
//      (skipped without the sidechain high-pass: the detector reads x);
//   B  parallel over samples, all warps: the detector input's level in dB
//      and the drives of phase C's envelopes;
//   C  serial, one recurrence per lane, each kind on warps of its own: the
//      low, voiced, presence and RMS one-poles (env' = c env + drive); the
//      peak envelope (attack/release select); on the non-adaptive path the
//      release time, whose target is a constant of the block;
//   D  parallel: the detector weight, the blended detector level in dB and
//      the static curve -> target GR; non-adaptive: the release coefficient
//      of every sample from its release time and phase E's two drives;
//   E  serial, one lane per stream: the GR smoothing (adaptive: the fast and
//      slow envelopes with it, kept as rows);
//   F  parallel: y = x * 10^(-GR/20) * makeup over the x row; adaptive: the
//      release-time target of every sample from the previous sample's fast
//      and slow envelopes;
//   G  adaptive only, serial: the release time's smoothing (it feeds nothing
//      back, only its last value is kept);
// then the tile is copied back to y. Every value is computed by the plain
// twin's expression in its order. The serial lanes run straight-line code
// (selects) through afk_serial_loop, which reads the next samples' inputs
// while the current ones step.
//
// Bound: the serial phases (three or four of T steps; a step is a load, one
// to four dependent f32 operations and a store, on one warp in order) and
// the parallel phases' precise log10f, powf, sqrtf and divisions (~800
// instructions a sample on sixteen warps); bytes (one read of x, one write
// of y) are far below them.
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
    S_PRESENCE_BAND_ENV_SQ, S_PLOSIVE_RATIO, S_COUNT,
    // scratch beside the state: the fast and slow envelopes at the chunk's
    // start, for the first sample's release-time target (phase F)
    S_FAST_AT_START = S_COUNT, S_SLOW_AT_START, CS_STATE_ROWS
};

constexpr int CS_STREAMS = 8;    // streams per block: 128 blocks for a fleet of 1024
constexpr int CS_LANES = 8;      // serial lanes per stream (four used)
constexpr int CS_THREADS = 512;  // sixteen warps for the parallel phases
static_assert(3 * CS_STREAMS * CS_LANES <= CS_THREADS, "serial lanes exceed the block");

// Rows of the shared tile, each CS_STREAMS rows of `stride` words (row r of
// stream g at (r * CS_STREAMS + g) * stride).
enum {
    CR_X = 0,       // x, then y
    CR_DET = 1,     // the high-passed detector input, then the peak
                    // envelope's attack drive
    CR_PEAK = 2,    // instantaneous peak dB, then the peak envelope
    CR_LOW = 3,     // low band drive, envelope, then target GR, then GR
    CR_VOICED = 4,  // voiced band drive, envelope; then the GR's attack drive
                    // (adaptive: the fast envelope)
    CR_PRES = 5,    // presence band drive, envelope; then the GR's release
                    // drive (adaptive: the slow envelope)
    CR_RMS = 6,     // RMS drive, then envelope
    CR_REL = 7,     // release time, then its coefficient (non-adaptive);
                    // the release-time target (adaptive)
    CR_ROWS = 8
};
// 16 KB of tile per stream: 8 rows of up to 484 samples
constexpr int CS_TILE_SMEM_BYTES = CS_STREAMS * 16 * 1024;

// The one-pole lanes of phase C.
enum { CL_LOW, CL_VOICED, CL_PRES, CL_RMS, CL_COUNT };

struct CompressorConsts {
    float rms_c, band_c, rel_smooth_c, fast_c, charge_c, slow_c, fs;
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

// Row r of stream g in the tile; state or parameter k of stream g.
AFK_HD float* cs_row(float* tile, int stride, int r, int g) {
    return tile + (r * CS_STREAMS + g) * stride;
}
AFK_HD float& cs_at(float* table, int k, int g) { return table[k * CS_STREAMS + g]; }
AFK_HD float cs_at(const float* table, int k, int g) { return table[k * CS_STREAMS + g]; }

// Phase A, stream g: the sidechain high-pass of the x row -> the DET row.
struct CsHighpassStep {
    float hp_c, sc_in, sc_out;
    float* det;
    AFK_HD void operator()(int t, const float (&v)[1]) {
        sc_out = hp_c * (sc_out + v[0] - sc_in);
        sc_in = v[0];
        det[t] = sc_out;
    }
};

AFK_HD void cs_phase_highpass(float* tile, int stride, int g, int tc, float* st,
                              const float* pr) {
    const float* const in[1] = {cs_row(tile, stride, CR_X, g)};
    CsHighpassStep step{cs_at(pr, P_SIDECHAIN_HP_COEFF, g), cs_at(st, S_SC_PREV_IN, g),
                        cs_at(st, S_SC_PREV_OUT, g), cs_row(tile, stride, CR_DET, g)};
    afk_serial_loop(in, tc, step);
    cs_at(st, S_SC_PREV_IN, g) = step.sc_in;
    cs_at(st, S_SC_PREV_OUT, g) = step.sc_out;
}

// Phase B for sample t of stream g: what phase C's recurrences add per
// sample, over the rows their envelopes go to: (1 - c) w w of the RMS
// envelope and (sidechain) of the three band envelopes, the detector input's
// level in dB for the peak envelope and its attack drive (1 - attack) level,
// over the DET row.
template <bool SC>
AFK_HD void cs_sample_drives(float* tile, int stride, int g, int t, const float* pr,
                             const CompressorConsts& k) {
    const float xt = cs_row(tile, stride, CR_X, g)[t];
    float* det = cs_row(tile, stride, CR_DET, g);
    const float d = SC ? det[t] : xt;
    const float level_db = afk_linear_to_db(fmaxf(fabsf(d), 1e-10f), -200.0f);
    cs_row(tile, stride, CR_PEAK, g)[t] = level_db;
    det[t] = (1.0f - cs_at(pr, P_ATTACK_COEFF, g)) * level_db;
    cs_row(tile, stride, CR_RMS, g)[t] = (1.0f - k.rms_c) * d * d;
    if (SC) {
        const float band_1 = 1.0f - k.band_c;
        const float low_c = xt - d;
        const float presence_c = 0.65f * d + 0.35f * (d - low_c);
        cs_row(tile, stride, CR_LOW, g)[t] = band_1 * low_c * low_c;
        cs_row(tile, stride, CR_VOICED, g)[t] = band_1 * d * d;
        cs_row(tile, stride, CR_PRES, g)[t] = band_1 * presence_c * presence_c;
    }
}

// Whether phase C runs one-pole lane `lane`: the band envelopes need the
// sidechain high-pass.
template <bool SC>
AFK_HD bool cs_lane_runs(int lane) {
    return lane < CL_COUNT && (SC || lane == CL_RMS);
}

// Phase C, one-pole lane `lane` of stream g: env' = c env + drive over the
// lane's row, in place.
struct CsOnePoleStep {
    float c, env;
    float* out;
    AFK_HD void operator()(int t, const float (&v)[1]) {
        env = c * env + v[0];
        out[t] = env;
    }
};

AFK_HD void cs_phase_one_pole(int lane, float* tile, int stride, int g, int tc, float* st,
                              const CompressorConsts& k) {
    const int key = lane == CL_LOW      ? S_LOW_BAND_ENV_SQ
                    : lane == CL_VOICED ? S_VOICED_BAND_ENV_SQ
                    : lane == CL_PRES   ? S_PRESENCE_BAND_ENV_SQ
                                        : S_RMS_ENVELOPE_SQ;
    const int row = lane == CL_LOW ? CR_LOW : lane == CL_VOICED ? CR_VOICED
                    : lane == CL_PRES ? CR_PRES : CR_RMS;
    float* out = cs_row(tile, stride, row, g);
    const float* const in[1] = {out};
    CsOnePoleStep step{lane == CL_RMS ? k.rms_c : k.band_c, cs_at(st, key, g), out};
    afk_serial_loop(in, tc, step);
    cs_at(st, key, g) = step.env;
}

// Phase C, stream g: the peak envelope over the level row, in place; attack
// or release by the level against the envelope; v = {level, attack drive}.
struct CsPeakStep {
    float atk, rel, rel1, env;
    float* out;
    AFK_HD void operator()(int t, const float (&v)[2]) {
        const float drive_r = rel1 * v[0];
        const bool up = v[0] > env;
        env = (up ? atk : rel) * env + (up ? v[1] : drive_r);
        out[t] = env;
    }
};

AFK_HD void cs_phase_peak(float* tile, int stride, int g, int tc, float* st, const float* pr) {
    float* out = cs_row(tile, stride, CR_PEAK, g);
    const float* const in[2] = {out, cs_row(tile, stride, CR_DET, g)};
    const float rel = cs_at(pr, P_DETECTOR_RELEASE_COEFF, g);
    CsPeakStep step{cs_at(pr, P_ATTACK_COEFF, g), rel, 1.0f - rel,
                    cs_at(st, S_PEAK_ENVELOPE_DB, g), out};
    afk_serial_loop(in, tc, step);
    cs_at(st, S_PEAK_ENVELOPE_DB, g) = step.env;
}

// The release time smoothed toward its target; within 1 ms it jumps there.
AFK_HD float cs_release_step(float cur, float target, float c, float c1) {
    const float smooth = c * cur + c1 * target;
    return fabsf(target - cur) > 1.0f ? smooth : target;
}

// Phase C (non-adaptive), stream g: the release time of every sample -> REL
// row. Its target is a constant of the block, so it reads no audio and runs
// beside the envelope lanes on a warp of its own.
AFK_HD void cs_phase_release_base(float* tile, int stride, int g, int tc, float* st,
                                  const float* pr, const CompressorConsts& k) {
    float* out = cs_row(tile, stride, CR_REL, g);
    const float target = cs_at(pr, P_BASE_RELEASE_MS, g);
    const float c = k.rel_smooth_c, c1 = 1.0f - k.rel_smooth_c;
    float cur = cs_at(st, S_CURRENT_RELEASE_MS, g);
#pragma unroll 4
    for (int t = 0; t < tc; ++t) {
        cur = cs_release_step(cur, target, c, c1);
        out[t] = cur;
    }
    cs_at(st, S_CURRENT_RELEASE_MS, g) = cur;
}

// Phase D for sample t of stream g (of a chunk of tc): the detector weight
// from the band envelopes, the blended detector level and the static curve
// -> target GR over the LOW row; non-adaptive: the release time of the
// sample -> its coefficient. The chunk's last sample leaves its plosive
// ratio in the state.
template <bool SC, bool ADAPT>
AFK_HD void cs_sample_target(float* tile, int stride, int g, int t, int tc, float* st,
                             const float* pr, const CompressorConsts& k) {
    float det_weight = 1.0f, plosive_ratio = 0.0f;
    if (SC) {
        const float low_rms = sqrtf(cs_row(tile, stride, CR_LOW, g)[t]);
        const float voiced_rms = fmaxf(sqrtf(cs_row(tile, stride, CR_VOICED, g)[t]), 1e-8f);
        const float pres_rms = sqrtf(cs_row(tile, stride, CR_PRES, g)[t]);
        plosive_ratio = afk_clip(low_rms / voiced_rms, 0.0f, 32.0f);
        const float amount = afk_clip((plosive_ratio - 1.25f) / 3.75f, 0.0f, 1.0f);
        const float penalty = 1.0f - amount * 0.65f;
        const float pres_ratio = afk_clip(pres_rms / voiced_rms, 0.0f, 4.0f);
        const float pres_weight = 1.0f + 0.18f * afk_clip(pres_ratio - 0.75f, 0.0f, 1.0f);
        det_weight = afk_clip(penalty * pres_weight, 0.35f, 1.15f);
    }
    const float peak_env = cs_row(tile, stride, CR_PEAK, g)[t];
    const float rms_env = cs_row(tile, stride, CR_RMS, g)[t];
    const float blended =
        0.6f * powf(10.0f, peak_env / 20.0f) + 0.4f * fmaxf(sqrtf(rms_env), 1e-10f);
    const float detector_db =
        afk_linear_to_db(fmaxf(blended, 1e-10f) * fmaxf(det_weight, 1e-10f), -200.0f);
    const float target_gr = comp_gain_reduction(detector_db, cs_at(pr, P_THRESHOLD_DB, g),
                                                cs_at(pr, P_RATIO, g), cs_at(pr, P_KNEE_DB, g));
    cs_row(tile, stride, CR_LOW, g)[t] = target_gr;
    if (!ADAPT) {  // the release coefficient and both of phase E's drives
        float* rel = cs_row(tile, stride, CR_REL, g);
        const float rx = -1000.0f / (fmaxf(rel[t], 1e-6f) * k.fs);
        const float rel_c = 1.0f + rx + 0.5f * rx * rx;
        rel[t] = rel_c;
        cs_row(tile, stride, CR_VOICED, g)[t] = (1.0f - cs_at(pr, P_ATTACK_COEFF, g)) * target_gr;
        cs_row(tile, stride, CR_PRES, g)[t] = (1.0f - rel_c) * target_gr;
    }
    if (t == tc - 1) cs_at(st, S_PLOSIVE_RATIO, g) = plosive_ratio;
}

// Phase E, stream g: the GR smoothing over the target row (in place); the
// adaptive path keeps its fast and slow envelopes as rows for phase F.
struct CsReductionStep {  // non-adaptive
    float atk, cur_gr;
    float* gr;
    // v = {target GR, release coefficient, attack drive, release drive}
    AFK_HD void operator()(int t, const float (&v)[4]) {
        const bool up = v[0] > cur_gr;
        cur_gr = (up ? atk : v[1]) * cur_gr + (up ? v[2] : v[3]);
        gr[t] = cur_gr;
    }
};

struct CsAdaptiveStep {  // v = {target GR}
    float atk, atk1, fast_c, fast1, charge_c, charge1, slow_c;
    float cur_gr, fast_env, slow_env;
    float *gr, *fast, *slow;
    AFK_HD void operator()(int t, const float (&v)[1]) {
        const float target_gr = v[0];
        const float attack = atk * cur_gr + atk1 * target_gr;
        const float release = fast_c * fast_env + fast1 * target_gr;
        const float charge = charge_c * slow_env + charge1 * target_gr;
        const float decay = slow_c * slow_env;
        fast_env = target_gr > cur_gr ? attack : release;
        slow_env = target_gr > 3.0f ? charge : decay;
        cur_gr = fmaxf(fast_env, slow_env);
        fast[t] = fast_env;
        slow[t] = slow_env;
        gr[t] = cur_gr;
    }
};

template <bool ADAPT>
AFK_HD void cs_phase_reduction(float* tile, int stride, int g, int tc, float* st,
                               const float* pr, const CompressorConsts& k) {
    if (tc <= 0) return;
    float* gr = cs_row(tile, stride, CR_LOW, g);
    const float atk = cs_at(pr, P_ATTACK_COEFF, g);
    if (ADAPT) {
        cs_at(st, S_FAST_AT_START, g) = cs_at(st, S_FAST_RELEASE_ENV_DB, g);
        cs_at(st, S_SLOW_AT_START, g) = cs_at(st, S_SLOW_RELEASE_ENV_DB, g);
        const float* const in[1] = {gr};
        CsAdaptiveStep step{atk, 1.0f - atk, k.fast_c, 1.0f - k.fast_c, k.charge_c,
                            1.0f - k.charge_c, k.slow_c, cs_at(st, S_CURRENT_GR_DB, g),
                            cs_at(st, S_FAST_RELEASE_ENV_DB, g),
                            cs_at(st, S_SLOW_RELEASE_ENV_DB, g), gr,
                            cs_row(tile, stride, CR_VOICED, g), cs_row(tile, stride, CR_PRES, g)};
        afk_serial_loop(in, tc, step);
        cs_at(st, S_CURRENT_GR_DB, g) = step.cur_gr;
        cs_at(st, S_FAST_RELEASE_ENV_DB, g) = step.fast_env;
        cs_at(st, S_SLOW_RELEASE_ENV_DB, g) = step.slow_env;
    } else {
        const float* const in[4] = {gr, cs_row(tile, stride, CR_REL, g),
                                    cs_row(tile, stride, CR_VOICED, g),
                                    cs_row(tile, stride, CR_PRES, g)};
        CsReductionStep step{atk, cs_at(st, S_CURRENT_GR_DB, g), gr};
        afk_serial_loop(in, tc, step);
        cs_at(st, S_CURRENT_GR_DB, g) = step.cur_gr;
        cs_at(st, S_FAST_RELEASE_ENV_DB, g) = step.cur_gr;
        cs_at(st, S_SLOW_RELEASE_ENV_DB, g) = 0.0f;
    }
}

// Phase F for sample t of stream g: the output over the x row; adaptive:
// the release-time target from the previous sample's fast and slow
// envelopes -> the REL row.
template <bool ADAPT>
AFK_HD void cs_sample_output(float* tile, int stride, int g, int t, float* st,
                             const float* pr) {
    float* x = cs_row(tile, stride, CR_X, g);
    const float cur_gr = cs_row(tile, stride, CR_LOW, g)[t];
    x[t] = x[t] * powf(10.0f, -cur_gr / 20.0f) * cs_at(pr, P_MAKEUP_LIN, g);
    if (ADAPT) {
        const float fast_env = t > 0 ? cs_row(tile, stride, CR_VOICED, g)[t - 1]
                                     : cs_at(st, S_FAST_AT_START, g);
        const float slow_env = t > 0 ? cs_row(tile, stride, CR_PRES, g)[t - 1]
                                     : cs_at(st, S_SLOW_AT_START, g);
        const float sustained = afk_clip(slow_env / 6.0f, 0.0f, 1.0f);
        const float transient = afk_clip((fast_env - slow_env) / 7.0f, 0.0f, 1.0f);
        const float syllabic =
            afk_clip(sustained * sustained * (1.0f - 0.35f * transient), 0.0f, 1.0f);
        cs_row(tile, stride, CR_REL, g)[t] = 50.0f + syllabic * 350.0f;
    }
}

// Phase G (adaptive), stream g: the release time smoothed toward the
// targets of the REL row; only its last value is kept.
struct CsReleaseStep {
    float c, c1, cur;
    AFK_HD void operator()(int, const float (&v)[1]) { cur = cs_release_step(cur, v[0], c, c1); }
};

AFK_HD void cs_phase_release(float* tile, int stride, int g, int tc, float* st,
                             const CompressorConsts& k) {
    const float* const in[1] = {cs_row(tile, stride, CR_REL, g)};
    CsReleaseStep step{k.rel_smooth_c, 1.0f - k.rel_smooth_c, cs_at(st, S_CURRENT_RELEASE_MS, g)};
    afk_serial_loop(in, tc, step);
    cs_at(st, S_CURRENT_RELEASE_MS, g) = step.cur;
}

#ifdef __CUDACC__
template <bool SC, bool ADAPT>
__global__ void __launch_bounds__(CS_THREADS)
compressor_scan_kernel(const float* __restrict__ x, const float* __restrict__ params,
                       const float* __restrict__ state_in, float* __restrict__ y,
                       float* __restrict__ state_out, int N, int T, int tc_max, int stride,
                       CompressorConsts k) {
    extern __shared__ __align__(16) float tile[];  // [CR_ROWS][CS_STREAMS][stride]
    float* st = tile + CR_ROWS * CS_STREAMS * stride;  // [CS_STATE_ROWS][CS_STREAMS]
    float* pr = st + CS_STATE_ROWS * CS_STREAMS;       // [P_COUNT][CS_STREAMS]
    const int n0 = blockIdx.x * CS_STREAMS;
    const int rows = afk_imin(CS_STREAMS, N - n0);
    for (int i = threadIdx.x; i < S_COUNT * CS_STREAMS; i += CS_THREADS) {
        const int key = i / CS_STREAMS, g = i % CS_STREAMS;
        if (g < rows) st[i] = state_in[(long long)key * N + n0 + g];
    }
    for (int i = threadIdx.x; i < P_COUNT * CS_STREAMS; i += CS_THREADS) {
        const int key = i / CS_STREAMS, g = i % CS_STREAMS;
        if (g < rows) pr[i] = params[(long long)key * N + n0 + g];
    }
    // the serial phases run on the first warps, thread = stream * 8 + lane;
    // in phase C the one-pole lanes there, the peak envelope on the warps
    // after them and the non-adaptive release time on the next, so that each
    // warp runs one short step
    constexpr int SERIAL = CS_STREAMS * CS_LANES;
    const int g = (threadIdx.x % SERIAL) / CS_LANES, lane = threadIdx.x % CS_LANES;
    const int role = threadIdx.x / SERIAL;
    const bool active = g < rows && role == 0;
    const bool peak_lane = g < rows && role == 1 && lane == 0;
    const bool release_lane = !ADAPT && g < rows && role == 2 && lane == 0;

    for (int c0 = 0; c0 < T; c0 += tc_max) {
        const int tc = afk_imin(tc_max, T - c0);
        // ends with a block barrier: the state and parameters are in place too
        afk_tile_load(tile, stride, x + (long long)n0 * T, rows, T, c0, tc);

        if (SC) {  // A: the sidechain high-pass
            if (active && lane == 0) cs_phase_highpass(tile, stride, g, tc, st, pr);
            __syncthreads();
        }
        // B: the level and the envelopes' drives of every sample
        for (int i = threadIdx.x; i < rows * tc; i += CS_THREADS) {
            const int gi = i / tc;
            cs_sample_drives<SC>(tile, stride, gi, i - gi * tc, pr, k);
        }
        __syncthreads();
        if (active && cs_lane_runs<SC>(lane))  // C: the envelopes
            cs_phase_one_pole(lane, tile, stride, g, tc, st, k);
        if (peak_lane) cs_phase_peak(tile, stride, g, tc, st, pr);
        if (release_lane) cs_phase_release_base(tile, stride, g, tc, st, pr, k);
        __syncthreads();
        // D: the target GR (and release coefficient) of every sample
        for (int i = threadIdx.x; i < rows * tc; i += CS_THREADS) {
            const int gi = i / tc;
            cs_sample_target<SC, ADAPT>(tile, stride, gi, i - gi * tc, tc, st, pr, k);
        }
        __syncthreads();
        if (active && lane == 0)  // E: the GR smoothing
            cs_phase_reduction<ADAPT>(tile, stride, g, tc, st, pr, k);
        __syncthreads();
        // F: the output (and release-time target) of every sample
        for (int i = threadIdx.x; i < rows * tc; i += CS_THREADS) {
            const int gi = i / tc;
            cs_sample_output<ADAPT>(tile, stride, gi, i - gi * tc, st, pr);
        }
        if (ADAPT) {  // G: the release time
            __syncthreads();
            if (active && lane == 0) cs_phase_release(tile, stride, g, tc, st, k);
        }
        afk_tile_store(tile, stride, y + (long long)n0 * T, rows, T, c0, tc);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < S_COUNT * CS_STREAMS; i += CS_THREADS) {
        const int key = i / CS_STREAMS, gi = i % CS_STREAMS;
        if (gi < rows) state_out[(long long)key * N + n0 + gi] = st[i];
    }
}

template <bool SC, bool ADAPT>
static int compressor_launch(const float* x, const float* params, const float* state_in,
                             float* y, float* state_out, int N, int T,
                             const CompressorConsts& k, cudaStream_t st) {
    const int tc_max = afk_imax(afk_tile_chunk(T, CR_ROWS * CS_STREAMS, CS_TILE_SMEM_BYTES), 4);
    const int stride = afk_tile_stride(tc_max);
    const size_t smem = sizeof(float) * (CR_ROWS * CS_STREAMS * stride
                                         + (CS_STATE_ROWS + P_COUNT) * CS_STREAMS);
    static size_t allowed = 0;  // one per instantiation
    const int err = afk_allow_smem(compressor_scan_kernel<SC, ADAPT>, smem, allowed);
    if (err != 0) return err;
    compressor_scan_kernel<SC, ADAPT><<<(N + CS_STREAMS - 1) / CS_STREAMS, CS_THREADS, smem, st>>>(
        x, params, state_in, y, state_out, N, T, tc_max, stride, k);
    return static_cast<int>(cudaGetLastError());
}

AFK_API int afk_compressor_scan(const float* x, const float* params,
                                const float* state_in, float* y,
                                float* state_out, int N, int T, float rms_c,
                                float band_c, float rel_smooth_c, float fast_c,
                                float charge_c, float slow_c, float fs,
                                int adaptive_release, int sidechain_hp,
                                void* stream) {
    if (T < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (N <= 0) return 0;
    const CompressorConsts k{rms_c, band_c, rel_smooth_c, fast_c, charge_c, slow_c, fs};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (sidechain_hp)
        return adaptive_release
                   ? compressor_launch<true, true>(x, params, state_in, y, state_out, N, T, k, st)
                   : compressor_launch<true, false>(x, params, state_in, y, state_out, N, T, k, st);
    return adaptive_release
               ? compressor_launch<false, true>(x, params, state_in, y, state_out, N, T, k, st)
               : compressor_launch<false, false>(x, params, state_in, y, state_out, N, T, k, st);
}
#endif

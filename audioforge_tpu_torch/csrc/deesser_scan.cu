// deesser_scan: the de-esser, one lane per band for its recurrences, its
// feed-forward math spread over the block's samples, over a shared-memory
// tile of the block.
//
// Replaces the TPU path's three phases (audioforge_tpu/ops/deesser.py):
//   1. the 6 detector biquads, HP then LP per band (detector_filter_block,
//      :145-171), run there as parallel associative scans;
//   2. the 13-state envelope/confidence/baseline/reduction step
//      (make_envelope_step, :199-328; lax.scan at :371);
//   3. the 3 dynamic peaking biquads whose coefficients follow the band
//      reduction per sample (dynamic_peaking_coeffs :185, applied at
//      :379-385) as time-varying associative scans.
// The gain computer (auto or manual) is a template parameter.
//
// Layouts: x, y [N, T] f32 (stream-major); state [33, N] f32 key-major
// (DS_* rows, the SCAN_STATE_KEYS order of ops/deesser.py); the constants
// arrive as a host f32 array (DeesserConsts) copied into the kernel's
// parameters at launch.
//
// Design. Of the per-sample step only a few values carry from one sample to
// the next: the detector filters' state and the envelopes, each band's
// confidence and baseline, the reductions, the dynamic filters' state. The
// rest (two log10f, a sqrtf and seven divisions per band; the scale; the
// dynamic bands' exp10f and divisions) depends on the carried values of the
// same sample only. A block owns DS_STREAMS streams and eight warps, stages
// its rows of x in shared memory (afk_tile_load; chunked over T to fit the
// tile) and runs each chunk in phases, with a block barrier between them:
//   A  serial, warp 0, one lane per band (lane 3: the broadband envelope):
//      the detector HP->LP pair and envelope of every sample -> env rows;
//   B  parallel over samples, all warps: from the four envelopes of a
//      sample, each band's clipped confidence target, spectral ratio and
//      voice-activity flag (manual: band level) -> feed-forward rows;
//   C  serial, lane per band: the confidence and baseline recurrences;
//   D  parallel: each band's target from them, the total target, its scale,
//      target * scale;
//   E  serial, lane per band: the reduction's smoothing -> reduction rows;
//   F  parallel: the dynamic peaking coefficients of every sample and band;
//   G  serial, the three dynamic bands in series as a 3-lane wavefront (like
//      biquad_cascade): at step k band b filters sample t = k - b, its input
//      from band b-1 by __shfl_up_sync, band 2 writing y[t] over x[t];
// then the tile is copied back to y. Every value is computed by the plain
// twin's expression in its order; built with -fmad=false
// (kernels/__init__.py), so every product and sum rounds as in the plain
// twin and the detector's threshold tests see the plain twin's values.
//
// Bound: the serial phases' recurrences (a few dependent f32 operations per
// sample and band in A, C and E, and the wavefront's shuffle and DF2T per
// step in G) and the parallel phases' throughput of the precise log10f, exp10f,
// sqrtf and divisions; bytes and operations are far below them.
#include "afk.cuh"

#include <cstring>

constexpr int DS_BANDS = 3;
constexpr int DS_LANES = 4;      // serial lanes per stream: three bands, broadband
constexpr int DS_STREAMS = 8;    // streams per block: warp 0 holds their lanes
constexpr int DS_THREADS = 256;  // eight warps for the parallel phases

// Rows of the shared tile, each DS_STREAMS rows of `stride` words (row r of
// stream g at (r * DS_STREAMS + g) * stride).
enum {
    DR_X = 0,        // x, then y
    DR_ENV = 1,      // 4: band envelopes and the broadband one; then baselines,
                     //    then scaled targets
    DR_CT = 5,       // 3: clipped confidence targets, then confidences
    DR_RATIO = 8,    // 3: spectral ratios
    DR_AUX = 11,     // 3: voice-activity flag (auto) or band level (manual)
    DR_RED = 14,     // 3: reductions
    DR_COEF = 1,     // 12: b0, b1 (= a1), b2, a2 per dynamic band, over the
                     //     envelope to aux rows (free by then)
    DR_ROWS = 17
};
constexpr int DS_TILE_SMEM_BYTES = 200 * 1024;

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

AFK_HD float ds_pick(int b, float v0, float v1, float v2) {
    return b == 0 ? v0 : b == 1 ? v1 : v2;
}

// One serial lane of one stream. Band lanes (lane < 3) use every field; the
// broadband lane keeps the broadband envelope in `env` and the stream's
// current reduction and detector confidence in `red` and `conf`.
struct DsLane {
    float det[2][5];  // this band's HP, LP detector coefficients
    float zd[2][2], zy[2];
    float env, conf, base, red;
};

// Load lane `lane`'s detector coefficients (static indices only, selected by
// band) and state; s_in points at the stream's column of the [33, N] state,
// ss = N.
AFK_HD void ds_lane_load(DsLane& L, int lane, const float* s_in, int ss,
                         const DeesserConsts& k) {
    const int b = lane < DS_BANDS ? lane : 0;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
#pragma unroll
        for (int i = 0; i < 5; ++i)
            L.det[f][i] = ds_pick(b, k.det[0][f][i], k.det[1][f][i], k.det[2][f][i]);
        L.zd[f][0] = s_in[(DS_DET_Z + b * 4 + f * 2) * ss];
        L.zd[f][1] = s_in[(DS_DET_Z + b * 4 + f * 2 + 1) * ss];
    }
    L.zy[0] = s_in[(DS_DYN_Z + b * 2) * ss];
    L.zy[1] = s_in[(DS_DYN_Z + b * 2 + 1) * ss];
    L.base = s_in[(DS_BASELINE_EXCESS_DB + b) * ss];
    if (lane < DS_BANDS) {
        L.env = s_in[(DS_BAND_ENV + b) * ss];
        L.conf = s_in[(DS_BAND_CONFIDENCE + b) * ss];
        L.red = s_in[(DS_REDUCTION_DB + b) * ss];
    } else {
        L.env = s_in[DS_BROADBAND_ENV * ss];
        L.conf = s_in[DS_DETECTOR_CONFIDENCE * ss];
        L.red = s_in[DS_CURRENT_REDUCTION_DB * ss];
    }
}

// Phase A: the band's HP->LP sidechain and envelope, or the broadband
// envelope on the broadband lane (band false), whose detector filters run on
// and are never stored. Returns the lane's envelope.
AFK_HD float ds_detect(DsLane& L, bool band, float xt, const DeesserConsts& k) {
    const float h = ds_df2t(L.det[0], L.zd[0][0], L.zd[0][1], xt);
    const float side = ds_df2t(L.det[1], L.zd[1][0], L.zd[1][1], h);
    L.env = ds_smooth(L.env, fabsf(band ? side : xt), k.det_atk, k.det_rel);
    return L.env;
}

// Phase B: the feed-forward part of one sample's gain computer, from the
// three band envelopes and the broadband one: each band's clipped
// confidence target, spectral ratio, and `aux` (auto: 1 where voice is
// active, else 0; manual: the band level in dB).
template <bool AUTO>
AFK_HD void ds_band_inputs(float e0, float e1, float e2, float broad, float* ct,
                           float* ratio, float* aux) {
    const float total_env = e0 + e1 + e2;
    const float max_env = fmaxf(fmaxf(e0, e1), e2);
    const float voice_db =
        afk_linear_to_db(fmaxf(broad - total_env * 0.6f, 1e-8f), -200.0f);
    const float narrowness =
        total_env > 1e-10f ? max_env / fmaxf(total_env, 1e-30f) : 0.0f;
    const float voice_conf = afk_clip((voice_db + 58.0f) / 24.0f, 0.0f, 1.0f);
    const float narrow_gain =
        0.35f + 0.65f * afk_clip((narrowness - 0.34f) / 0.34f, 0.0f, 1.0f);
    const float env[DS_BANDS] = {e0, e1, e2};
#pragma unroll
    for (int b = 0; b < DS_BANDS; ++b) {
        const float band_db = afk_linear_to_db(fmaxf(env[b], 1e-10f), -200.0f);
        const float r = fmaxf(band_db - voice_db, 0.0f);
        const float dominance =
            max_env > 1e-10f ? sqrtf(env[b] / fmaxf(max_env, 1e-30f)) : 0.0f;
        const float ratio_conf = afk_clip((r - 1.5f) / 8.5f, 0.0f, 1.0f);
        const float level_conf = afk_clip((band_db + 62.0f) / 38.0f, 0.0f, 1.0f);
        const float narrow_support = (r > 6.0f && band_db > -45.0f) ? 0.75f : 0.0f;
        const float voice_support = fmaxf(voice_conf, narrow_support);
        const float balance =
            ratio_conf > 0.12f ? fmaxf(ratio_conf, voice_support * 0.65f) : ratio_conf;
        const float penalty = 0.35f + 0.65f * balance;
        const float conf_target =
            ((0.62f * ratio_conf + 0.18f * level_conf + 0.20f * voice_support) * penalty
             * narrow_gain) * dominance;
        ct[b] = afk_clip(conf_target, 0.0f, 1.0f);
        ratio[b] = r;
        aux[b] = AUTO ? ((voice_db > -55.0f || band_db > -55.0f) ? 1.0f : 0.0f) : band_db;
    }
}

// Phase C: a band lane's confidence and (auto) baseline recurrences for one
// sample.
template <bool AUTO>
AFK_HD void ds_recur(DsLane& L, float ct, float ratio, float aux, const DeesserConsts& k) {
    L.conf = ds_smooth(L.conf, ct, k.det_atk, k.det_rel);
    if (AUTO) {
        const float base_target = afk_clip(ratio * 0.45f, 0.0f, 24.0f);
        const float bc = base_target < L.base ? k.base_fall : k.base_rise;
        const float active = bc * L.base + (1.0f - bc) * base_target;
        L.base = aux > 0.5f ? active : L.base * k.base_decay;
    }
}

// Phase D: a band's target reduction from its confidence and baseline after
// the sample (phase C), its spectral ratio and aux.
template <bool AUTO>
AFK_HD float ds_target(float conf, float base, float ratio, float aux,
                       const DeesserConsts& k) {
    if (AUTO) {
        const float conf_gain =
            afk_clip((conf - k.conf_floor) / (1.0f - k.conf_floor), 0.0f, 1.0f);
        const float over = fmaxf(ratio - base - k.trigger_offset, 0.0f);
        return afk_clip(over * k.slope * conf_gain, 0.0f, k.auto_cap);
    }
    const float band_db = aux;
    const float conf_gain = afk_clip((conf - 0.22f) / 0.78f, 0.0f, 1.0f);
    const float ratio_over = ratio - k.ratio_thr;
    const float over = fminf(band_db - k.thr, ratio_over);
    return (band_db > k.thr && ratio_over > 0.0f)
               ? afk_clip(k.comp_factor * over * conf_gain, 0.0f, k.max_red * 0.75f)
               : 0.0f;
}

// Phase D: the scale of one sample's three targets to the maximum reduction.
AFK_HD float ds_scale(float t0, float t1, float t2, const DeesserConsts& k) {
    const float total_target = t0 + t1 + t2;
    return total_target > fmaxf(k.max_red, 0.0f) ? k.max_red / fmaxf(total_target, 1e-30f)
                                                  : 1.0f;
}

// Phase E: a band lane's reduction, smoothed toward its scaled target.
AFK_HD float ds_reduce(DsLane& L, float scaled_target, const DeesserConsts& k) {
    L.red = ds_smooth(L.red, scaled_target, k.atk, k.rel);
    return L.red;
}

// Phase F: dynamic band b's peaking coefficients for reduction `red`,
// c = b0 b1 b2 a1 a2 (a1 == b1).
AFK_HD void ds_dyn_coeffs(int b, float red, const DeesserConsts& k, float* c) {
    const float alpha = ds_pick(b, k.alpha[0], k.alpha[1], k.alpha[2]);
    const float neg2cos = ds_pick(b, k.neg2cos[0], k.neg2cos[1], k.neg2cos[2]);
    const float A = exp10f(-red / 40.0f);  // 10 ** (-red / 40)
    const float a0 = 1.0f + alpha / A;
    c[0] = (1.0f + alpha * A) / a0;
    c[1] = neg2cos / a0;
    c[2] = (1.0f - alpha * A) / a0;
    c[3] = c[1];
    c[4] = (1.0f - alpha / A) / a0;
}

// Phase G, step k of the wavefront for lane b of a chunk of tc samples: band
// b < 3 filters sample t = k - b with `c` (the coefficients of that sample)
// and commits the result if t lies in [0, tc); `in` is x[t] for b == 0, else
// band b-1's output of step k-1. Band 2 writes its output over row[t].
AFK_HD void ds_dyn_wave_step(DsLane& L, float& v, float in, const float* c, int k,
                             int b, int tc, float* row) {
    const int t = k - b;
    const bool valid = b < DS_BANDS && t >= 0 && t < tc;
    float z1 = L.zy[0], z2 = L.zy[1];
    const float out = ds_df2t(c, z1, z2, in);
    L.zy[0] = valid ? z1 : L.zy[0];
    L.zy[1] = valid ? z2 : L.zy[1];
    v = valid ? out : v;
    if (valid && b == DS_BANDS - 1) row[t] = out;
}

// The stream's current reduction and detector confidence from the bands'
// final reduction and confidence.
AFK_HD float ds_total_reduction(float r0, float r1, float r2, const DeesserConsts& k) {
    return fminf(r0 + r1 + r2, k.max_red);
}

AFK_HD float ds_detector_confidence(float c0, float c1, float c2) {
    return afk_clip(fmaxf(fmaxf(c0, c1), c2), 0.0f, 1.0f);
}

// Store lane `lane`'s state; the broadband lane also stores the stream's
// current reduction and detector confidence held in its red and conf.
AFK_HD void ds_lane_store(const DsLane& L, int lane, float* s_out, int ss) {
    if (lane >= DS_BANDS) {
        s_out[DS_BROADBAND_ENV * ss] = L.env;
        s_out[DS_CURRENT_REDUCTION_DB * ss] = L.red;
        s_out[DS_DETECTOR_CONFIDENCE * ss] = L.conf;
        return;
    }
    const int b = lane;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
        s_out[(DS_DET_Z + b * 4 + f * 2) * ss] = L.zd[f][0];
        s_out[(DS_DET_Z + b * 4 + f * 2 + 1) * ss] = L.zd[f][1];
    }
    s_out[(DS_DYN_Z + b * 2) * ss] = L.zy[0];
    s_out[(DS_DYN_Z + b * 2 + 1) * ss] = L.zy[1];
    s_out[(DS_BAND_ENV + b) * ss] = L.env;
    s_out[(DS_BAND_CONFIDENCE + b) * ss] = L.conf;
    s_out[(DS_BASELINE_EXCESS_DB + b) * ss] = L.base;
    s_out[(DS_REDUCTION_DB + b) * ss] = L.red;
}

// Row r of stream g in the tile.
AFK_HD float* ds_row(float* tile, int stride, int r, int g) {
    return tile + (r * DS_STREAMS + g) * stride;
}

// The serial phases of one lane over a chunk of the tile; the loops are
// unrolled so the feed-forward work of neighbouring samples overlaps.
// Phase A: lane `lane` of stream g, x row -> its envelope row.
AFK_HD void ds_phase_detect(DsLane& L, int lane, float* tile, int stride, int g, int tc,
                            const DeesserConsts& k) {
    const float* __restrict__ x = ds_row(tile, stride, DR_X, g);
    float* __restrict__ env = ds_row(tile, stride, DR_ENV + lane, g);
    const bool band = lane < DS_BANDS;
#pragma unroll 4
    for (int t = 0; t < tc; ++t) env[t] = ds_detect(L, band, x[t], k);
}

// Phase C, band lane b of stream g: the confidence overwrites its target in
// the CT row; the baseline goes over the band's envelope row.
template <bool AUTO>
AFK_HD void ds_phase_recur(DsLane& L, int b, float* tile, int stride, int g, int tc,
                           const DeesserConsts& k) {
    float* __restrict__ ct_conf = ds_row(tile, stride, DR_CT + b, g);
    const float* __restrict__ ratio = ds_row(tile, stride, DR_RATIO + b, g);
    const float* __restrict__ aux = ds_row(tile, stride, DR_AUX + b, g);
    float* __restrict__ base = ds_row(tile, stride, DR_ENV + b, g);
#pragma unroll 4
    for (int t = 0; t < tc; ++t) {
        ds_recur<AUTO>(L, ct_conf[t], ratio[t], aux[t], k);
        ct_conf[t] = L.conf;
        base[t] = L.base;
    }
}

// Phase E, band lane b of stream g: scaled targets (over the envelope row)
// -> the reduction row.
AFK_HD void ds_phase_reduce(DsLane& L, int b, float* tile, int stride, int g, int tc,
                            const DeesserConsts& k) {
    const float* __restrict__ scaled = ds_row(tile, stride, DR_ENV + b, g);
    float* __restrict__ red = ds_row(tile, stride, DR_RED + b, g);
#pragma unroll 4
    for (int t = 0; t < tc; ++t) red[t] = ds_reduce(L, scaled[t], k);
}

// Phase B for sample t of stream g: the four envelopes -> the CT, RATIO and
// AUX rows.
template <bool AUTO>
AFK_HD void ds_sample_inputs(float* tile, int stride, int g, int t) {
    float ct[DS_BANDS], ratio[DS_BANDS], aux[DS_BANDS];
    ds_band_inputs<AUTO>(ds_row(tile, stride, DR_ENV + 0, g)[t],
                         ds_row(tile, stride, DR_ENV + 1, g)[t],
                         ds_row(tile, stride, DR_ENV + 2, g)[t],
                         ds_row(tile, stride, DR_ENV + 3, g)[t], ct, ratio, aux);
#pragma unroll
    for (int b = 0; b < DS_BANDS; ++b) {
        ds_row(tile, stride, DR_CT + b, g)[t] = ct[b];
        ds_row(tile, stride, DR_RATIO + b, g)[t] = ratio[b];
        ds_row(tile, stride, DR_AUX + b, g)[t] = aux[b];
    }
}

// Phase D for sample t of stream g: the three targets, scaled, over the
// band envelope (baseline) rows.
template <bool AUTO>
AFK_HD void ds_sample_targets(float* tile, int stride, int g, int t, const DeesserConsts& k) {
    float tg[DS_BANDS];
#pragma unroll
    for (int b = 0; b < DS_BANDS; ++b)
        tg[b] = ds_target<AUTO>(ds_row(tile, stride, DR_CT + b, g)[t],
                                ds_row(tile, stride, DR_ENV + b, g)[t],
                                ds_row(tile, stride, DR_RATIO + b, g)[t],
                                ds_row(tile, stride, DR_AUX + b, g)[t], k);
    const float scale = ds_scale(tg[0], tg[1], tg[2], k);
#pragma unroll
    for (int b = 0; b < DS_BANDS; ++b) ds_row(tile, stride, DR_ENV + b, g)[t] = tg[b] * scale;
}

// Phase F for sample t of dynamic band b of stream g: its reduction -> its
// four coefficient rows (b0, b1 = a1, b2, a2).
AFK_HD void ds_sample_coeffs(float* tile, int stride, int b, int g, int t,
                             const DeesserConsts& k) {
    float c[5];
    ds_dyn_coeffs(b, ds_row(tile, stride, DR_RED + b, g)[t], k, c);
    ds_row(tile, stride, DR_COEF + 4 * b + 0, g)[t] = c[0];
    ds_row(tile, stride, DR_COEF + 4 * b + 1, g)[t] = c[1];
    ds_row(tile, stride, DR_COEF + 4 * b + 2, g)[t] = c[2];
    ds_row(tile, stride, DR_COEF + 4 * b + 3, g)[t] = c[4];
}

// Phase G: dynamic band b's coefficients of sample t of stream g, from its
// coefficient rows.
AFK_HD void ds_coeffs_at(float* tile, int stride, int b, int g, int t, float* c) {
    c[0] = ds_row(tile, stride, DR_COEF + 4 * b + 0, g)[t];
    c[1] = ds_row(tile, stride, DR_COEF + 4 * b + 1, g)[t];
    c[2] = ds_row(tile, stride, DR_COEF + 4 * b + 2, g)[t];
    c[3] = c[1];
    c[4] = ds_row(tile, stride, DR_COEF + 4 * b + 3, g)[t];
}

#ifdef __CUDACC__
constexpr unsigned DS_FULL = 0xffffffffu;

template <bool AUTO>
__global__ void __launch_bounds__(DS_THREADS)
deesser_scan_kernel(const float* __restrict__ x, const float* __restrict__ s_in,
                    float* __restrict__ y, float* __restrict__ s_out, int N, int T,
                    int tc_max, int stride, const __grid_constant__ DeesserConsts k) {
    extern __shared__ __align__(16) float tile[];  // [DR_ROWS][DS_STREAMS][stride]
    const int n0 = blockIdx.x * DS_STREAMS;
    const int rows = afk_imin(DS_STREAMS, N - n0);
    // the serial phases run on warp 0, lane = stream * 4 + band
    const bool serial = threadIdx.x < DS_STREAMS * DS_LANES;
    const int g = threadIdx.x / DS_LANES, lane = threadIdx.x % DS_LANES;
    const bool active = serial && g < rows;
    const bool band = lane < DS_BANDS;
    const int n = n0 + g;
    DsLane L = {};
    if (active) ds_lane_load(L, lane, s_in + n, N, k);

    for (int c0 = 0; c0 < T; c0 += tc_max) {
        const int tc = afk_imin(tc_max, T - c0);
        afk_tile_load(tile, stride, x + (long long)n0 * T, rows, T, c0, tc);

        if (active)  // A: detectors and envelopes
            ds_phase_detect(L, lane, tile, stride, g, tc, k);
        __syncthreads();
        // B: the feed-forward gain inputs of every sample
#pragma unroll 2
        for (int i = threadIdx.x; i < rows * tc; i += DS_THREADS) {
            const int gi = i / tc;
            ds_sample_inputs<AUTO>(tile, stride, gi, i - gi * tc);
        }
        __syncthreads();
        if (active && band)  // C: confidence and baseline
            ds_phase_recur<AUTO>(L, lane, tile, stride, g, tc, k);
        __syncthreads();
        // D: the three targets of every sample, scaled
#pragma unroll 2
        for (int i = threadIdx.x; i < rows * tc; i += DS_THREADS) {
            const int gi = i / tc;
            ds_sample_targets<AUTO>(tile, stride, gi, i - gi * tc, k);
        }
        __syncthreads();
        if (active && band)  // E: reductions
            ds_phase_reduce(L, lane, tile, stride, g, tc, k);
        __syncthreads();
        // F: the dynamic peaking coefficients of every sample and band
#pragma unroll 2
        for (int i = threadIdx.x; i < DS_BANDS * rows * tc; i += DS_THREADS) {
            const int bg = i / tc, t = i - bg * tc;
            const int b = bg / rows;
            ds_sample_coeffs(tile, stride, b, bg - b * rows, t, k);
        }
        __syncthreads();
        if (serial) {  // G: the dynamic bands as a wavefront, all of warp 0
            float* row = ds_row(tile, stride, DR_X, g);
            const int b = band ? lane : 0;
            float v = 0.0f;
            float xk = row[0];
            // this step's coefficients, read a step ahead (sample index
            // clamped into the chunk; unused outside it)
            float c[5];
            ds_coeffs_at(tile, stride, b, g, 0, c);
            for (int kk = 0; kk < tc + DS_BANDS - 1; ++kk) {
                const float x_next = row[afk_imin(kk + 1, tc - 1)];
                const int tn = afk_imax(0, afk_imin(kk + 1 - lane, tc - 1));
                float cn[5];
                ds_coeffs_at(tile, stride, b, g, tn, cn);
                const float up = __shfl_up_sync(DS_FULL, v, 1, DS_LANES);
                const float in = lane == 0 ? xk : up;
                if (active) ds_dyn_wave_step(L, v, in, c, kk, lane, tc, row);
#pragma unroll
                for (int i = 0; i < 5; ++i) c[i] = cn[i];
                xk = x_next;
            }
        }
        afk_tile_store(tile, stride, y + (long long)n0 * T, rows, T, c0, tc);
    }

    if (!serial) return;
    // the stream's current reduction and detector confidence, on lane 3
    const int base = threadIdx.x & ~(DS_LANES - 1);
    const float r0 = __shfl_sync(DS_FULL, L.red, base + 0);
    const float r1 = __shfl_sync(DS_FULL, L.red, base + 1);
    const float r2 = __shfl_sync(DS_FULL, L.red, base + 2);
    const float q0 = __shfl_sync(DS_FULL, L.conf, base + 0);
    const float q1 = __shfl_sync(DS_FULL, L.conf, base + 1);
    const float q2 = __shfl_sync(DS_FULL, L.conf, base + 2);
    if (!active) return;
    if (!band && T > 0) {
        L.red = ds_total_reduction(r0, r1, r2, k);
        L.conf = ds_detector_confidence(q0, q1, q2);
    }
    ds_lane_store(L, lane, s_out + n, N);
}

AFK_API int afk_deesser_scan(const float* x, const float* s_in, float* y,
                             float* s_out, int N, int T,
                             const float* host_consts, int n_consts,
                             int auto_mode, void* stream) {
    if (n_consts != DS_CONSTS || T < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (N <= 0) return 0;
    DeesserConsts k;
    std::memcpy(&k, host_consts, sizeof(k));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tc_max = afk_tile_chunk(T, DR_ROWS * DS_STREAMS, DS_TILE_SMEM_BYTES);
    const int stride = afk_tile_stride(tc_max);
    const size_t smem = sizeof(float) * DR_ROWS * DS_STREAMS * stride;
    const int blocks = (N + DS_STREAMS - 1) / DS_STREAMS;
    static AfkSmemAllowed allowed_true, allowed_false;
    int err;
    if (auto_mode) {
        err = afk_allow_smem(deesser_scan_kernel<true>, smem, allowed_true);
        if (err == 0)
            deesser_scan_kernel<true><<<blocks, DS_THREADS, smem, st>>>(
                x, s_in, y, s_out, N, T, tc_max, stride, k);
    } else {
        err = afk_allow_smem(deesser_scan_kernel<false>, smem, allowed_false);
        if (err == 0)
            deesser_scan_kernel<false><<<blocks, DS_THREADS, smem, st>>>(
                x, s_in, y, s_out, N, T, tc_max, stride, k);
    }
    return err != 0 ? err : static_cast<int>(cudaGetLastError());
}
#endif

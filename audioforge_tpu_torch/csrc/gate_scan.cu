// gate_scan: the smart gate's per-sample step (downward expander with VAD
// fusion, chatter tracking and gain smoothing), its recurrences serial on a
// lane each and its feed-forward math spread over the block's samples, over a
// shared-memory tile of the block.
//
// Replaces the TPU path's lax.scan of the gate step
// (audioforge_tpu/ops/gate.py:233-456, scanned at :458): RMS detector with
// hold and hysteresis, level score, VAD-fused score and the five-state
// probability machine (VAD modes), chatter window/cooldown with auto-relax,
// target gain reduction and attack/release gain smoothing. The mode
// (threshold-only, VAD-assisted, VAD-only) is a template parameter.
//
// Layouts: x, y [N, T] f32 (stream-major). Key-major [K, N]: params [3, N]
// f32 (threshold_db, attack_coeff, release_coeff); VAD inputs [4, N] f32
// (probability, available 0/1, held 0/1, threshold); float state [7, N] f32
// and integer state [11, N] int32 (booleans as 0/1) in the GATE_FLOAT_KEYS /
// GATE_INT_KEYS order of ops/gate.py.
//
// Design. What carries from sample to sample is the RMS envelope, the
// smoothed VAD probability, the hold counter and open flag, the chatter
// counters, the machine's state and the gain. The level in dB (sqrtf,
// log10f), the level score (a division), the closure curve and the target
// gain (powf) depend on the carried values of the same sample only. A block
// owns GT_STREAMS streams and sixteen warps, stages its rows of x in shared
// memory (afk_tile_load; chunked over T where the tile would not fit), keeps
// the streams' state, parameters and VAD inputs in shared memory too, and
// runs each chunk in phases with a block barrier between them:
//   A  serial, a lane each: the RMS envelope and (VAD modes) the smoothed
//      probability, whose input is a constant of the block;
//   B  parallel over samples, all warps: the level in dB and the level score;
//   C  serial, integer, one lane per stream: hold, the open flag and the
//      peak level;
//   D  parallel: the target gain, 10^(-target GR / 20), threshold-only with
//      both terms phase E's attack/release select picks from. In the VAD modes the
//      gain feeds back into the machine, and chatter through auto-relax into
//      the range, so the phase computes the open machine's target gain for
//      both ranges (36 and 24 dB); the two closed gains are constants;
//   E  serial, one lane per stream: threshold-only: the gain's smoothing and,
//      on a warp of its own beside it, chatter tracking (there the effective
//      state is the open flag and neither reads the other; auto-relax, which
//      no chatter event starts in this mode, only runs down, so phase D knows
//      it for every sample); VAD modes: the fused score, the machine
//      (selects, no branches), chatter tracking, then one of the four gains
//      picked by the machine's state and auto-relax; every mode: the gain's
//      attack/release smoothing. No powf, log10f, sqrtf or division is left
//      on this chain;
//   F  parallel: y = x * gain over the x row;
// then the tile is copied back to y. Every value is computed by the plain
// twin's expression in its order, and the same powf of the same argument
// gives the twin's target gain. Built with -fmad=false (kernels/__init__.py):
// every product and sum rounds on its own, as the plain twin's elementwise
// ops round them, so the level that meets the >= threshold test is the plain
// twin's to the bit. The serial lanes run straight-line code through
// afk_serial_loop, which reads the next samples' inputs while the current
// ones step.
//
// Bound: the three serial phases of T steps (A: a multiply and an add; C:
// integer compares and selects; E: compares, selects and the gain's multiply
// and add, with the machine's boolean logic in the VAD modes) and the
// barriers between the phases; bytes and operations are far below them.
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

constexpr int GT_STREAMS = 8;    // streams per block: 128 blocks for a fleet of 1024
constexpr int GT_LANES = 8;      // a stream's serial thread is every eighth, so a
                                 // block's recurrences spread over two warps
constexpr int GT_THREADS = 512;  // sixteen warps for the parallel phases
static_assert(2 * GT_STREAMS * GT_LANES <= GT_THREADS, "serial lanes exceed the block");

// Rows of the shared tile, each GT_STREAMS rows of `stride` words (row r of
// stream g at (r * GT_STREAMS + g) * stride).
enum {
    GR_X = 0,      // x, then y
    GR_LEVEL = 1,  // RMS envelope, then the level in dB
    GR_SMOOTH = 2, // smoothed VAD probability (VAD modes); threshold-only: the
                   // gain's release drive
    GR_SCORE = 3,  // level score
    GR_OPEN = 4,   // open flag
    GR_GAIN = 5,   // target gain (VAD modes: at the 36 dB range), then the gain
    GR_GAIN24 = 6, // VAD modes: target gain at the auto-relax range of 24 dB;
                   // threshold-only: the gain's attack drive
    GR_ROWS = 7
};
// 16 KB of tile per stream: 7 rows of up to 556 samples
constexpr int GT_TILE_SMEM_BYTES = GT_STREAMS * 16 * 1024;

struct GateConsts {
    float rms_c, rms_1, sm_c, sm_1;
    int hold_samples, chatter_window, chatter_cooldown, auto_relax_samples;
};

// The streams' tables in shared memory, each [K][GT_STREAMS].
struct GateTables {
    float* fs;        // float state, GF_*
    int* is;          // integer state, GI_*
    const float* pr;  // params, GP_*
    const float* vad; // VAD inputs, GV_*
};

AFK_HD float* gt_row(float* tile, int stride, int r, int g) {
    return tile + (r * GT_STREAMS + g) * stride;
}
AFK_HD int gt_at(int k, int g) { return k * GT_STREAMS + g; }

// Block-constant VAD terms of one stream (ops/gate.py:117-130).
struct GateVad {
    float prob, vad_score, open_thr, c_close, span, prob_delta, scale;
    bool avail, held;
};

template <int MODE>
AFK_HD GateVad gt_vad_terms(const GateTables& tb, int g) {
    GateVad v = {};
    v.span = 1.0f;
    if (MODE != GATE_THRESHOLD_ONLY) {
        v.prob = tb.vad[gt_at(GV_PROBABILITY, g)];
        v.avail = tb.vad[gt_at(GV_AVAILABLE, g)] != 0.0f;
        v.held = tb.vad[gt_at(GV_HELD, g)] != 0.0f;
        v.open_thr = afk_clip(tb.vad[gt_at(GV_THRESHOLD, g)], 0.05f, 0.95f);
        v.prob_delta = v.prob - tb.fs[gt_at(GF_PREVIOUS_VAD_PROBABILITY, g)];
        v.vad_score = afk_clip(v.prob, 0.0f, 1.0f);
        v.c_close = fminf(fmaxf(v.open_thr - 0.20f, 0.02f), fmaxf(v.open_thr - 0.02f, 0.02f));
        v.span = fmaxf(v.open_thr - v.c_close, 1e-3f);
        v.scale = MODE == GATE_VAD_ASSISTED ? 0.30f : 0.45f;
    }
    return v;
}

// Phase A, stream g: the RMS envelope of the x row -> LEVEL row.
struct GtRmsStep {
    float rms_c, rms_1, rms_env;
    float* out;
    AFK_HD void operator()(int t, const float (&v)[1]) {
        rms_env = rms_c * rms_env + rms_1 * v[0] * v[0];
        out[t] = rms_env;
    }
};

AFK_HD void gt_phase_rms(float* tile, int stride, int g, int tc, const GateTables& tb,
                         const GateConsts& k) {
    const float* const in[1] = {gt_row(tile, stride, GR_X, g)};
    GtRmsStep step{k.rms_c, k.rms_1, tb.fs[gt_at(GF_RMS_ENVELOPE_SQ, g)],
                   gt_row(tile, stride, GR_LEVEL, g)};
    afk_serial_loop(in, tc, step);
    tb.fs[gt_at(GF_RMS_ENVELOPE_SQ, g)] = step.rms_env;
}

// Phase A (VAD modes), stream g: the smoothed probability -> SMOOTH row.
AFK_HD void gt_phase_smooth(float* tile, int stride, int g, int tc, const GateTables& tb,
                            const GateConsts& k) {
    float* out = gt_row(tile, stride, GR_SMOOTH, g);
    const float drive = k.sm_1 * tb.vad[gt_at(GV_PROBABILITY, g)];
    float smoothed = tb.fs[gt_at(GF_VAD_SMOOTHED_PROBABILITY, g)];
#pragma unroll 4
    for (int t = 0; t < tc; ++t) {
        smoothed = afk_clip(k.sm_c * smoothed + drive, 0.0f, 1.0f);
        out[t] = smoothed;
    }
    tb.fs[gt_at(GF_VAD_SMOOTHED_PROBABILITY, g)] = smoothed;
}

// Phase B for sample t of stream g (of a chunk of tc): the level in dB over
// the RMS envelope and the level score. The chunk's last sample leaves its
// level (and threshold-only: its score, the fused score there) in the state.
template <int MODE>
AFK_HD void gt_sample_level(float* tile, int stride, int g, int t, int tc,
                            const GateTables& tb) {
    float* level = gt_row(tile, stride, GR_LEVEL, g);
    const float thr = tb.pr[gt_at(GP_THRESHOLD_DB, g)];
    const float level_db = afk_linear_to_db(fmaxf(sqrtf(level[t]), 1e-10f), -200.0f);
    const float closed_db = thr - 4.0f;
    const float level_score = afk_clip((level_db - closed_db) / 4.0f, 0.0f, 1.0f);
    level[t] = level_db;
    gt_row(tile, stride, GR_SCORE, g)[t] = level_score;
    if (t == tc - 1) {
        tb.fs[gt_at(GF_DETECTOR_LEVEL_DB, g)] = level_db;
        if (MODE == GATE_THRESHOLD_ONLY) tb.fs[gt_at(GF_FUSED_GATE_SCORE, g)] = level_score;
    }
}

// The chatter tracker's state of one stream.
struct GateChatter {
    bool eff_open, has_eff;
    int win_rem, cnt, cooldown, events, relax_rem;
};

AFK_HD GateChatter gt_chatter_load(const GateTables& tb, int g) {
    GateChatter c;
    c.eff_open = tb.is[gt_at(GI_EFFECTIVE_GATE_OPEN, g)] != 0;
    c.has_eff = tb.is[gt_at(GI_HAS_EFFECTIVE_GATE_STATE, g)] != 0;
    c.win_rem = tb.is[gt_at(GI_CHATTER_WINDOW_REMAINING, g)];
    c.cnt = tb.is[gt_at(GI_CHATTER_TRANSITION_COUNT, g)];
    c.cooldown = tb.is[gt_at(GI_CHATTER_COOLDOWN, g)];
    c.events = tb.is[gt_at(GI_CHATTER_EVENT_COUNT, g)];
    c.relax_rem = tb.is[gt_at(GI_AUTO_RELAX_REMAINING, g)];
    return c;
}

AFK_HD void gt_chatter_store(const GateChatter& c, const GateTables& tb, int g) {
    tb.is[gt_at(GI_EFFECTIVE_GATE_OPEN, g)] = c.eff_open;
    tb.is[gt_at(GI_HAS_EFFECTIVE_GATE_STATE, g)] = c.has_eff;
    tb.is[gt_at(GI_CHATTER_WINDOW_REMAINING, g)] = c.win_rem;
    tb.is[gt_at(GI_CHATTER_TRANSITION_COUNT, g)] = c.cnt;
    tb.is[gt_at(GI_CHATTER_COOLDOWN, g)] = c.cooldown;
    tb.is[gt_at(GI_CHATTER_EVENT_COUNT, g)] = c.events;
    tb.is[gt_at(GI_AUTO_RELAX_REMAINING, g)] = c.relax_rem;
}

// One sample of chatter tracking on the effective open state; a fired
// chatter event starts the auto-relax period in the VAD modes.
template <int MODE>
AFK_HD void gt_chatter_step(GateChatter& c, bool effective_open, const GateConsts& k) {
    const bool first = !c.has_eff;
    const bool transitioned = !first & (effective_open != c.eff_open);
    const bool fresh = c.win_rem == 0;
    int win = (transitioned & fresh) ? k.chatter_window : c.win_rem;
    int cnt = transitioned ? (fresh ? 1 : c.cnt + 1) : c.cnt;
    const bool fire = transitioned & (cnt >= 4) & (c.cooldown == 0);
    c.events += fire ? 1 : 0;
    int cooldown = fire ? k.chatter_cooldown : c.cooldown;
    int relax = (MODE != GATE_THRESHOLD_ONLY && fire) ? k.auto_relax_samples : c.relax_rem;
    win = fire ? 0 : win;
    cnt = fire ? 0 : cnt;
    c.relax_rem = afk_imax(relax - 1, 0);
    c.win_rem = afk_imax(win - 1, 0);
    c.cnt = ((win > 0) & (c.win_rem == 0)) ? 0 : cnt;
    c.cooldown = afk_imax(cooldown - 1, 0);
    c.eff_open = (first | transitioned) ? effective_open : c.eff_open;
    c.has_eff = true;
}

// Phase C, stream g: hold, the open flag -> OPEN row, the peak level.
struct GtDetectStep {
    float thr, hyst, peak;
    int hold, hold_samples;
    bool is_open;
    float* open;
    AFK_HD void operator()(int t, const float (&v)[1]) {
        const float level_db = v[0];
        const bool above = level_db >= thr;
        const bool holding = !above & (hold > 0);
        hold = above ? hold_samples : afk_imax(hold - 1, 0);
        const bool below_hyst = level_db <= hyst;
        is_open = above | holding | (!below_hyst & is_open);
        peak = fmaxf(peak, level_db);
        open[t] = is_open ? 1.0f : 0.0f;
    }
};

AFK_HD void gt_phase_detect(float* tile, int stride, int g, int tc, const GateTables& tb,
                            const GateConsts& k) {
    if (tc <= 0) return;
    const float* const in[1] = {gt_row(tile, stride, GR_LEVEL, g)};
    const float thr = tb.pr[gt_at(GP_THRESHOLD_DB, g)];
    GtDetectStep step{thr, thr - 4.0f, tb.fs[gt_at(GF_PEAK_LEVEL, g)],
                      tb.is[gt_at(GI_HOLD_REMAINING, g)], k.hold_samples,
                      tb.is[gt_at(GI_IS_OPEN, g)] != 0, gt_row(tile, stride, GR_OPEN, g)};
    afk_serial_loop(in, tc, step);
    tb.is[gt_at(GI_HOLD_REMAINING, g)] = step.hold;
    tb.is[gt_at(GI_IS_OPEN, g)] = step.is_open;
    tb.fs[gt_at(GF_PEAK_LEVEL, g)] = step.peak;
}

// Phase E (threshold-only), stream g: chatter tracking on the open flag.
// There the effective state is the open flag and nothing reads the gain, so
// it runs beside the gain's smoothing on a warp of its own.
struct GtChatterStep {
    GateChatter ch;
    GateConsts k;
    AFK_HD void operator()(int, const float (&v)[1]) {
        gt_chatter_step<GATE_THRESHOLD_ONLY>(ch, v[0] != 0.0f, k);
    }
};

AFK_HD void gt_phase_chatter(float* tile, int stride, int g, int tc, const GateTables& tb,
                             const GateConsts& k) {
    const float* const in[1] = {gt_row(tile, stride, GR_OPEN, g)};
    GtChatterStep step{gt_chatter_load(tb, g), k};
    afk_serial_loop(in, tc, step);
    gt_chatter_store(step.ch, tb, g);
}

// The target gain of an open machine (threshold-only: of the gate, with no
// posterior reduction) at expander range `range_db`.
AFK_HD float gt_target_gain(float thr, float level_db, bool is_open, float range_db,
                            float posterior_gr) {
    const float detector_gr =
        is_open ? 0.0f : fminf(fmaxf((thr - level_db) * 0.75f, 0.0f), range_db);
    return powf(10.0f, -fmaxf(detector_gr, posterior_gr) / 20.0f);
}

// The target gain of a closed machine at `range_db`.
AFK_HD float gt_closed_gain(float range_db) { return powf(10.0f, -range_db / 20.0f); }

// Phase D for sample t of stream g: the target gain -> GAIN row, with
// (1 - attack) and (1 - release) times it for phase E (threshold-only);
// VAD modes: for both ranges -> GAIN and GAIN24 rows.
template <int MODE>
AFK_HD void gt_sample_target(float* tile, int stride, int g, int t, const GateTables& tb) {
    const float thr = tb.pr[gt_at(GP_THRESHOLD_DB, g)];
    const float level_db = gt_row(tile, stride, GR_LEVEL, g)[t];
    const bool is_open = gt_row(tile, stride, GR_OPEN, g)[t] != 0.0f;
    float* gain = gt_row(tile, stride, GR_GAIN, g);
    if (MODE == GATE_THRESHOLD_ONLY) {
        // no chatter event starts auto-relax in this mode: what is left of it
        // at the chunk's start only runs down
        const bool auto_relax = tb.is[gt_at(GI_AUTO_RELAX_REMAINING, g)] - t > 0;
        const float target_gain =
            gt_target_gain(thr, level_db, is_open, auto_relax ? 24.0f : 36.0f, 0.0f);
        gain[t] = target_gain;
        // both of phase E's drives, over the rows only the VAD modes use
        gt_row(tile, stride, GR_GAIN24, g)[t] =
            (1.0f - tb.pr[gt_at(GP_ATTACK_COEFF, g)]) * target_gain;
        gt_row(tile, stride, GR_SMOOTH, g)[t] =
            (1.0f - tb.pr[gt_at(GP_RELEASE_COEFF, g)]) * target_gain;
        return;
    }
    const GateVad v = gt_vad_terms<MODE>(tb, g);
    const float smoothed = gt_row(tile, stride, GR_SMOOTH, g)[t];
    const float normalized = afk_clip((smoothed - v.c_close) / v.span, 0.0f, 1.0f);
    float closure = 1.0f - normalized * normalized * (3.0f - 2.0f * normalized);
    if (v.held && smoothed >= v.open_thr - 0.20f) closure = fminf(closure, 0.80f);
    // posterior_gr = avail ? range_db * closure * scale : 0, per range
    const float gr36 = v.avail ? 36.0f * closure * v.scale : 0.0f;
    const float gr24 = v.avail ? 24.0f * closure * v.scale : 0.0f;
    gain[t] = gt_target_gain(thr, level_db, is_open, 36.0f, gr36);
    gt_row(tile, stride, GR_GAIN24, g)[t] = gt_target_gain(thr, level_db, is_open, 24.0f, gr24);
}

// The gain smoothed toward its target by attack or release; both drives are
// formed off the chain.
AFK_HD float gt_gain_step(float gain, float target_gain, float atk, float atk1, float rel,
                          float rel1) {
    float drive_a = atk1 * target_gain, drive_r = rel1 * target_gain;
    AFK_KEEP(drive_a);
    AFK_KEEP(drive_r);
    const bool up = target_gain > gain;
    return (up ? atk : rel) * gain + (up ? drive_a : drive_r);
}

// Phase E, threshold-only: the gain's smoothing over the GAIN row;
// v = {target gain, attack drive, release drive}.
struct GtGainStep {
    float atk, rel, gain;
    float* gain_row;
    AFK_HD void operator()(int t, const float (&v)[3]) {
        const bool up = v[0] > gain;
        gain = (up ? atk : rel) * gain + (up ? v[1] : v[2]);
        gain_row[t] = gain;
    }
};

// Phase E, VAD modes: the fused score, the probability machine, chatter
// tracking, the pick of the target gain and the gain's smoothing for one
// sample; v = {level score, open flag, open gain at 36 dB, at 24 dB}.
template <int MODE>
struct GtMachineStep {
    float atk, atk1, rel, rel1, gain, fused_score;
    int gs;
    bool fused_open;
    GateChatter ch;
    GateVad vt;
    GateConsts k;
    // the terms that auto-relax moves, for both of its values
    bool vad_open_n, vad_open_r, vad_unc_n, vad_unc_r;
    float closed36, closed24, only_score;
    float* gain_row;
    AFK_HD void operator()(int t, const float (&v)[4]) {
        const float level_score = v[0];
        const bool is_open = v[1] != 0.0f;
        const float gain_prev = gain;
        const bool auto_relax = ch.relax_rem > 0;
        const bool recent = fused_open | (gain_prev > 0.35f);
        if (MODE == GATE_VAD_ASSISTED) {
            // both values of `recent`, formed off the gain's chain
            const float mix = 0.55f * level_score + 0.45f * vt.vad_score;
            const float lead = fmaxf(level_score, vt.vad_score);
            const float avail1 = fmaxf(lead, afk_clip(mix + 0.10f * 1.0f, 0.0f, 1.0f));
            const float avail0 = fmaxf(lead, afk_clip(mix + 0.10f * 0.0f, 0.0f, 1.0f));
            const float alone1 = 0.85f * level_score + 0.15f * 1.0f;
            const float alone0 = 0.85f * level_score + 0.15f * 0.0f;
            fused_score = vt.avail ? (recent ? avail1 : avail0) : (recent ? alone1 : alone0);
        } else {
            fused_score = only_score;
        }
        fused_open = (fused_score >= 0.55f) | ((fused_score > 0.35f) & fused_open);

        const bool vad_open = auto_relax ? vad_open_r : vad_open_n;
        const bool vad_uncertain = auto_relax ? vad_unc_r : vad_unc_n;
        const bool level_open = is_open | (level_score >= 0.55f);
        const bool level_uncertain = (level_score >= 0.22f) | (gain_prev > 0.12f);
        const bool cand_ok = !vt.avail | vad_uncertain | (gain_prev > 0.20f);
        bool strong_open, sustain;
        if (MODE == GATE_VAD_ASSISTED) {
            strong_open = ((level_open | fused_open | vt.held) & cand_ok) | vad_open;
            sustain = strong_open | vad_uncertain | level_uncertain
                      | (auto_relax & (level_score > 0.08f));
        } else {
            strong_open = vt.held | vad_open;
            sustain = strong_open | vad_uncertain | (auto_relax & (gain_prev > 0.12f));
        }
        const bool releasing_sustain =
            sustain | ((gain_prev > 0.20f) & (vad_uncertain | auto_relax));
        const int fallback = sustain ? G_UNCERTAIN : (releasing_sustain ? G_RELEASING : G_CLOSED);
        const int from_closed = strong_open ? G_OPENING : G_CLOSED;
        const int from_opening = strong_open ? G_OPEN : (sustain ? G_UNCERTAIN : G_CLOSED);
        const int from_open = strong_open ? G_OPEN : fallback;
        const int from_other = strong_open ? G_OPENING : fallback;
        gs = gs == G_CLOSED ? from_closed
             : gs == G_OPENING ? from_opening
             : gs == G_OPEN    ? from_open
                               : from_other;
        const bool prob_open = gs != G_CLOSED;
        const float target_gain = prob_open ? (auto_relax ? v[3] : v[2])
                                            : (auto_relax ? closed24 : closed36);
        gt_chatter_step<MODE>(ch, prob_open, k);
        gain = gt_gain_step(gain_prev, target_gain, atk, atk1, rel, rel1);
        gain_row[t] = gain;
    }
};

// Phase E, stream g.
template <int MODE>
AFK_HD void gt_phase_gain(float* tile, int stride, int g, int tc, const GateTables& tb,
                          const GateConsts& k) {
    if (tc <= 0) return;
    float* gain_row = gt_row(tile, stride, GR_GAIN, g);
    const float atk = tb.pr[gt_at(GP_ATTACK_COEFF, g)], rel = tb.pr[gt_at(GP_RELEASE_COEFF, g)];
    const float gain = tb.fs[gt_at(GF_CURRENT_GAIN, g)];
    if (MODE == GATE_THRESHOLD_ONLY) {
        const float* const in[3] = {gain_row, gt_row(tile, stride, GR_GAIN24, g),
                                    gt_row(tile, stride, GR_SMOOTH, g)};
        GtGainStep step{atk, rel, gain, gain_row};
        afk_serial_loop(in, tc, step);
        tb.fs[gt_at(GF_CURRENT_GAIN, g)] = step.gain;
        return;
    }
    const GateVad v = gt_vad_terms<MODE>(tb, g);
    const float close_n = fminf(fmaxf(v.open_thr - 0.12f, 0.02f), v.open_thr);
    const float close_r = fminf(fmaxf(v.open_thr - 0.20f, 0.02f), v.open_thr);
    const bool onset = v.prob_delta >= 0.08f;
    const float only_score = v.avail ? (v.held ? fmaxf(v.vad_score, 0.55f) : v.vad_score)
                                     : (v.held ? 0.55f : 0.0f);
    const float* const in[4] = {gt_row(tile, stride, GR_SCORE, g), gt_row(tile, stride, GR_OPEN, g),
                                gain_row, gt_row(tile, stride, GR_GAIN24, g)};
    GtMachineStep<MODE> step{
        atk, 1.0f - atk, rel, 1.0f - rel, gain, tb.fs[gt_at(GF_FUSED_GATE_SCORE, g)],
        tb.is[gt_at(GI_GATE_STATE, g)], tb.is[gt_at(GI_FUSED_GATE_OPEN, g)] != 0,
        gt_chatter_load(tb, g), v, k,
        v.avail & ((v.prob >= v.open_thr) | (onset & (v.prob >= close_n))),
        v.avail & ((v.prob >= v.open_thr) | (onset & (v.prob >= close_r))),
        v.avail & (v.prob >= close_n), v.avail & (v.prob >= close_r),
        gt_closed_gain(36.0f), gt_closed_gain(24.0f), only_score, gain_row};
    afk_serial_loop(in, tc, step);
    tb.fs[gt_at(GF_CURRENT_GAIN, g)] = step.gain;
    tb.fs[gt_at(GF_FUSED_GATE_SCORE, g)] = step.fused_score;
    tb.is[gt_at(GI_GATE_STATE, g)] = step.gs;
    tb.is[gt_at(GI_FUSED_GATE_OPEN, g)] = step.fused_open;
    gt_chatter_store(step.ch, tb, g);
}

// Phase F for sample t of stream g: the output over the x row.
AFK_HD void gt_sample_output(float* tile, int stride, int g, int t) {
    gt_row(tile, stride, GR_X, g)[t] *= gt_row(tile, stride, GR_GAIN, g)[t];
}

// After the block's last chunk: the probability the next block's onset
// velocity is measured from.
template <int MODE>
AFK_HD void gt_finish(const GateTables& tb, int g) {
    if (MODE != GATE_THRESHOLD_ONLY)
        tb.fs[gt_at(GF_PREVIOUS_VAD_PROBABILITY, g)] = tb.vad[gt_at(GV_PROBABILITY, g)];
}

#ifdef __CUDACC__
template <int MODE>
__global__ void __launch_bounds__(GT_THREADS, 1)
gate_scan_kernel(const float* __restrict__ x, const float* __restrict__ params,
                 const float* __restrict__ vad, const float* __restrict__ fs_in,
                 const int* __restrict__ is_in, float* __restrict__ y,
                 float* __restrict__ fs_out, int* __restrict__ is_out, int N, int T,
                 int tc_max, int stride, GateConsts k) {
    extern __shared__ __align__(16) float tile[];  // [GR_ROWS][GT_STREAMS][stride]
    float* fs = tile + GR_ROWS * GT_STREAMS * stride;
    int* is = reinterpret_cast<int*>(fs + GF_COUNT * GT_STREAMS);
    float* pr = reinterpret_cast<float*>(is + GI_COUNT * GT_STREAMS);
    float* vd = pr + GP_COUNT * GT_STREAMS;
    const GateTables tb{fs, is, pr, vd};
    const int n0 = blockIdx.x * GT_STREAMS;
    const int rows = afk_imin(GT_STREAMS, N - n0);
    for (int i = threadIdx.x; i < GI_COUNT * GT_STREAMS; i += GT_THREADS) {
        const int key = i / GT_STREAMS, g = i % GT_STREAMS;
        if (g >= rows) continue;
        const long long at = (long long)key * N + n0 + g;
        is[i] = is_in[at];
        if (key < GF_COUNT) fs[i] = fs_in[at];
        if (key < GP_COUNT) pr[i] = params[at];
        if (MODE != GATE_THRESHOLD_ONLY && key < GV_COUNT) vd[i] = vad[at];
    }
    // the serial phases run on the first warps, thread = stream * 8 + lane;
    // a second recurrence of a phase (A: the smoothed probability; E,
    // threshold-only: chatter) on the warps after them, `beside`
    constexpr int SERIAL = GT_STREAMS * GT_LANES;
    const int g = (threadIdx.x % SERIAL) / GT_LANES, lane = threadIdx.x % GT_LANES;
    const bool active = g < rows && threadIdx.x < SERIAL;
    const bool beside = g < rows && lane == 0 && threadIdx.x >= SERIAL
                        && threadIdx.x < 2 * SERIAL;

    for (int c0 = 0; c0 < T; c0 += tc_max) {
        const int tc = afk_imin(tc_max, T - c0);
        // ends with a block barrier: the streams' tables are in place too
        afk_tile_load(tile, stride, x + (long long)n0 * T, rows, T, c0, tc);

        if (active && lane == 0) gt_phase_rms(tile, stride, g, tc, tb, k);  // A
        if (MODE != GATE_THRESHOLD_ONLY && beside) gt_phase_smooth(tile, stride, g, tc, tb, k);
        __syncthreads();
        // B: the level and its score of every sample
        for (int i = threadIdx.x; i < rows * tc; i += GT_THREADS) {
            const int gi = i / tc;
            gt_sample_level<MODE>(tile, stride, gi, i - gi * tc, tc, tb);
        }
        __syncthreads();
        if (active && lane == 0) gt_phase_detect(tile, stride, g, tc, tb, k);  // C
        __syncthreads();
        // D: the target gain of every sample
        for (int i = threadIdx.x; i < rows * tc; i += GT_THREADS) {
            const int gi = i / tc;
            gt_sample_target<MODE>(tile, stride, gi, i - gi * tc, tb);
        }
        __syncthreads();
        if (active && lane == 0) gt_phase_gain<MODE>(tile, stride, g, tc, tb, k);  // E
        if (MODE == GATE_THRESHOLD_ONLY && beside) gt_phase_chatter(tile, stride, g, tc, tb, k);
        __syncthreads();
        // F: the output
        for (int i = threadIdx.x; i < rows * tc; i += GT_THREADS) {
            const int gi = i / tc;
            gt_sample_output(tile, stride, gi, i - gi * tc);
        }
        afk_tile_store(tile, stride, y + (long long)n0 * T, rows, T, c0, tc);
    }
    __syncthreads();
    if (active && lane == 0) gt_finish<MODE>(tb, g);
    __syncthreads();
    for (int i = threadIdx.x; i < GI_COUNT * GT_STREAMS; i += GT_THREADS) {
        const int key = i / GT_STREAMS, gi = i % GT_STREAMS;
        if (gi >= rows) continue;
        const long long at = (long long)key * N + n0 + gi;
        is_out[at] = is[i];
        if (key < GF_COUNT) fs_out[at] = fs[i];
    }
}

template <int MODE>
static int gate_launch(const float* x, const float* params, const float* vad,
                       const float* fs_in, const int* is_in, float* y, float* fs_out,
                       int* is_out, int N, int T, const GateConsts& k, cudaStream_t st) {
    const int tc_max = afk_imax(afk_tile_chunk(T, GR_ROWS * GT_STREAMS, GT_TILE_SMEM_BYTES), 4);
    const int stride = afk_tile_stride(tc_max);
    const size_t smem = sizeof(float) * (GR_ROWS * GT_STREAMS * stride
                                         + (GF_COUNT + GI_COUNT + GP_COUNT + GV_COUNT) * GT_STREAMS);
    static size_t allowed = 0;  // one per instantiation
    const int err = afk_allow_smem(gate_scan_kernel<MODE>, smem, allowed);
    if (err != 0) return err;
    gate_scan_kernel<MODE><<<(N + GT_STREAMS - 1) / GT_STREAMS, GT_THREADS, smem, st>>>(
        x, params, vad, fs_in, is_in, y, fs_out, is_out, N, T, tc_max, stride, k);
    return static_cast<int>(cudaGetLastError());
}

AFK_API int afk_gate_scan(const float* x, const float* params,
                          const float* vad, const float* fs_in,
                          const int* is_in, float* y, float* fs_out,
                          int* is_out, int N, int T, int mode, float rms_c,
                          float rms_1, float sm_c, float sm_1,
                          int hold_samples, int chatter_window,
                          int chatter_cooldown, int auto_relax_samples,
                          void* stream) {
    if (T < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (N <= 0) return 0;
    const GateConsts k{rms_c, rms_1, sm_c, sm_1, hold_samples, chatter_window,
                       chatter_cooldown, auto_relax_samples};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case GATE_THRESHOLD_ONLY:
            return gate_launch<GATE_THRESHOLD_ONLY>(x, params, vad, fs_in, is_in, y, fs_out,
                                                    is_out, N, T, k, st);
        case GATE_VAD_ASSISTED:
            return gate_launch<GATE_VAD_ASSISTED>(x, params, vad, fs_in, is_in, y, fs_out,
                                                  is_out, N, T, k, st);
        case GATE_VAD_ONLY:
            return gate_launch<GATE_VAD_ONLY>(x, params, vad, fs_in, is_in, y, fs_out, is_out,
                                              N, T, k, st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
#endif

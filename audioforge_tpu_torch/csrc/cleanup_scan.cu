// cleanup_scan: the per-sample part of gentle/strong input cleanup over a
// shared-memory tile of the block: the f64 DC blocker and notches as a
// wavefront on two warps, the rumble detector's recurrences and its
// feed-forward math on the other warps beside it.
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
//     their state is native f64: the pending lane starts from zero at a
//     retune, advances only while a fade is in flight and is held while
//     idle, and the lanes blend with
//     w = clip((total - remaining + 1 + t) / total, 0, 1).
// The block-level hum analysis, the notch retune/promotion and the owned
// high-pass (a 1-section biquad_cascade launch that needs the rumble hold at
// the END of the block) stay in the wrapper.
//
// Layouts: x, y [N, T] f32 (stream-major); key-major [K, N]: fin [8, N] f32
// (CF_* rows; fout holds the first 6), iin [10, N] int32 (CI_* rows; iout
// holds the rumble hold). Each notch's leaves as the state keeps them: coeffs
// [N, 2, 5] f32 (crossfade lane, b0 b1 b2 a1 a2) and z [N, 2, 2] f64
// (crossfade lane, z1 z2), read and written in place of any packed copy.
//
// Design. A block owns CL_STREAMS streams, stages their rows of x in shared
// memory (afk_tile_load; chunked over T where the tile would not fit) and
// runs two things side by side, which read x and nothing of each other:
//
//   The f64 chain, on the first two warps, as a wavefront of three stages:
//   the DC blocker, the hum notch, the harmonic notch, each a sample behind
//   the stage before (step k, stage j filters sample k - j), its input the
//   stage before's output of the step before by __shfl_sync. A stream has
//   five lanes: the DC blocker (as a DF2T section b = [1, -1, 0],
//   a = [1, -dc, 0], so every lane runs the same straight-line biquad step)
//   and each notch's active and pending crossfade lanes, stepped in parallel;
//   the notch's first lane takes the pending lane's output by
//   __shfl_down_sync, blends and mixes by the strength. Coefficients and
//   state stay in registers. An idle pending lane steps too and stores the
//   state it was given (held), which keeps selects off the chain; a warp none
//   of whose notches fades (the steady state) leaves out the second shuffle
//   and the blend. The crossfade weights of four steps are formed ahead of
//   them (afk_quotient: a multiply and two FMAs for the f64 division, the
//   same bits); the f32 -> f64 of x and f64 -> f32 of y lie off the chain.
//
//   The rumble detector (f32), on the other warps, with a barrier of their
//   own between its phases:
//     A  serial, a warp each: the 150 Hz low-pass of x (its magnitude to a
//        row) and the broadband envelope of |x|;
//     B  serial, a warp each: the attack/release low envelope and the slow
//        low envelope of the low-pass's magnitude;
//     C  all samples: the two divisions, the window context at the sample
//        (hum hold, candidate and window counts before and after the
//        window's boundary) and the trigger.
//   The rumble hold leaves the kernel only as its value at the block's end,
//   so it is a reduction: with t_last the last sample whose trigger is true
//   (a shared-memory atomicMax), hold_set - (T - 1 - t_last) floored at 0,
//   or the hold before less T where none fired.
//
// Built with -fmad=false (kernels/__init__.py), so the rumble envelopes
// round as the plain twin's do and the trigger's comparisons match it.
//
// Bound: the wavefront's T + 2 steps of two shuffles and five dependent f64
// operations (one shuffle and three operations in the steady state); bytes
// and operations are far below it.
#include "afk.cuh"

enum {
    CF_LOWPASS, CF_LOW_ENV, CF_SLOW_LOW_ENV, CF_BROADBAND_ENV, CF_DC_X1,
    CF_DC_Y1, CF_HUM_STRENGTH, CF_HARM_STRENGTH, CF_COUNT
};
constexpr int CF_RUMBLE = CF_DC_X1;  // the first rows are the rumble detector's state
enum {
    CI_RUMBLE_HOLD, CI_BOUNDARY, CI_HOLD0, CI_HOLD_AFTER, CI_CAND0,
    CI_CAND_NEW, CI_WOBS0, CI_WOBS_NEW, CI_FADE_HUM, CI_FADE_HARM, CI_COUNT
};

constexpr int CL_STREAMS = 8;   // streams per block: 128 blocks for a fleet of 1024
constexpr int CL_LANES = 8;     // wavefront lanes per stream, five in use
constexpr int CL_USED_LANES = 5;
constexpr int CL_STAGES = 3;    // DC blocker, hum notch, harmonic notch
constexpr int CL_LAST_MIX = 3;  // the harmonic notch's first lane writes y
constexpr int CL_GROUP = 4;     // steps per group (one float4 of x)
constexpr int CL_WAVE_THREADS = CL_STREAMS * CL_LANES;  // the first two warps
constexpr int CL_THREADS = 512;
constexpr int CL_RUMBLE_THREADS = CL_THREADS - CL_WAVE_THREADS;
static_assert(CL_WAVE_THREADS % 32 == 0 && CL_RUMBLE_THREADS >= 64, "warps of either part");

// Rows of the shared tile, each CL_STREAMS rows of `stride` words (row r of
// stream g at (r * CL_STREAMS + g) * stride).
enum {
    KR_X = 0,      // x
    KR_LA = 1,     // |low-pass of x|
    KR_LOW = 2,    // low envelope
    KR_SLOW = 3,   // slow low envelope
    KR_BROAD = 4,  // broadband envelope
    KR_Y = 5,      // y
    KR_ROWS = 6
};
// 12 KB of tile per stream: 6 rows of up to 484 samples
constexpr int CL_TILE_SMEM_BYTES = CL_STREAMS * 12 * 1024;

struct CleanupConsts {
    float lp_c, env_thr, burst_thr;
    int rumble_hold_set, fade_total;
    double dc_coeff;
};

AFK_HD float* cl_row(float* tile, int stride, int r, int g) {
    return tile + (r * CL_STREAMS + g) * stride;
}
AFK_HD int cl_at(int k, int g) { return k * CL_STREAMS + g; }

// ---------------------------------------------------------------------------
// The rumble detector. fs: the streams' detector state [CF_RUMBLE][CL_STREAMS];
// ci: their integer rows [CI_COUNT][CL_STREAMS].
// ---------------------------------------------------------------------------

// s += c (x - s), |s| to the row
struct ClLowpassStep {
    float c, s;
    float* out;
    AFK_HD void operator()(int t, const float (&v)[1]) {
        s = s + c * (v[0] - s);
        out[t] = fabsf(s);
    }
};

struct ClBroadStep {
    float s;
    float* out;
    AFK_HD void operator()(int t, const float (&v)[1]) {
        s = s + 0.02f * (fabsf(v[0]) - s);
        out[t] = s;
    }
};

struct ClLowEnvStep {
    float s;
    float* out;
    AFK_HD void operator()(int t, const float (&v)[1]) {
        s = s + (v[0] > s ? 0.08f : 0.006f) * (v[0] - s);
        out[t] = s;
    }
};

struct ClSlowEnvStep {
    float s;
    float* out;
    AFK_HD void operator()(int t, const float (&v)[1]) {
        s = s + 0.0012f * (v[0] - s);
        out[t] = s;
    }
};

// Serial, stream g: the recurrence `step` (from state row `key`, writing its
// own row) over row `from`; its value after the chunk back to the state.
template <typename Step>
AFK_HD void cl_phase_run(Step step, float* tile, int stride, int from, int g, int tc,
                         float* fs, int key) {
    const float* const in[1] = {cl_row(tile, stride, from, g)};
    afk_serial_loop(in, tc, step);
    fs[cl_at(key, g)] = step.s;
}

// Phase A, stream g: the low-pass of x, its magnitude -> LA row.
AFK_HD void cl_phase_lowpass(float* tile, int stride, int g, int tc, float* fs,
                             const CleanupConsts& k) {
    cl_phase_run(ClLowpassStep{k.lp_c, fs[cl_at(CF_LOWPASS, g)], cl_row(tile, stride, KR_LA, g)},
                 tile, stride, KR_X, g, tc, fs, CF_LOWPASS);
}

// Phase A, stream g: the broadband envelope of |x| -> BROAD row.
AFK_HD void cl_phase_broad(float* tile, int stride, int g, int tc, float* fs) {
    cl_phase_run(ClBroadStep{fs[cl_at(CF_BROADBAND_ENV, g)], cl_row(tile, stride, KR_BROAD, g)},
                 tile, stride, KR_X, g, tc, fs, CF_BROADBAND_ENV);
}

// Phase B, stream g: the low envelope of the LA row -> LOW row.
AFK_HD void cl_phase_low(float* tile, int stride, int g, int tc, float* fs) {
    cl_phase_run(ClLowEnvStep{fs[cl_at(CF_LOW_ENV, g)], cl_row(tile, stride, KR_LOW, g)},
                 tile, stride, KR_LA, g, tc, fs, CF_LOW_ENV);
}

// Phase B, stream g: the slow low envelope of the LA row -> SLOW row.
AFK_HD void cl_phase_slow(float* tile, int stride, int g, int tc, float* fs) {
    cl_phase_run(ClSlowEnvStep{fs[cl_at(CF_SLOW_LOW_ENV, g)], cl_row(tile, stride, KR_SLOW, g)},
                 tile, stride, KR_LA, g, tc, fs, CF_SLOW_LOW_ENV);
}

// Phase C for sample t of stream g's chunk, the block's sample tb: whether
// the rumble trigger fires.
AFK_HD bool cl_sample_trigger(float* tile, int stride, int g, int t, int tb, const int* ci,
                              const CleanupConsts& k) {
    const int boundary = ci[cl_at(CI_BOUNDARY, g)];
    const bool pre = tb < boundary;
    const int hh = pre ? afk_imax(ci[cl_at(CI_HOLD0, g)] - tb, 0)
                       : afk_imax(ci[cl_at(CI_HOLD_AFTER, g)] - (tb - boundary), 0);
    const int cw = pre ? ci[cl_at(CI_CAND0, g)] : ci[cl_at(CI_CAND_NEW, g)];
    const int wo = pre ? ci[cl_at(CI_WOBS0, g)] : ci[cl_at(CI_WOBS_NEW, g)];
    const float low = cl_row(tile, stride, KR_LOW, g)[t];
    const float slow = cl_row(tile, stride, KR_SLOW, g)[t];
    const float broad = cl_row(tile, stride, KR_BROAD, g)[t];
    const float burst = low / fmaxf(slow, 0.006f);
    const float dom = low / fmaxf(broad, 0.01f);
    const bool startup = wo == 0 && low > 0.45f;
    const bool established = wo > 0 && slow > 0.012f;
    return (startup || established) && hh == 0 && cw == 0 && low > k.env_thr
           && burst > k.burst_thr && dom > 0.62f;
}

// The rumble hold after a block of T samples from `hold0`, the trigger last
// true at the block's sample t_last (-1: at none).
AFK_HD int cl_rumble_hold_end(int hold0, int t_last, int T, int hold_set) {
    return t_last >= 0 ? afk_imax(hold_set - (T - 1 - t_last), 0) : afk_imax(hold0 - T, 0);
}

// ---------------------------------------------------------------------------
// The f64 chain. Lane l of a stream: 0 the DC blocker; 1, 2 the hum notch's
// active and pending crossfade lanes; 3, 4 the harmonic notch's.
// ---------------------------------------------------------------------------

AFK_HD int cl_lane_stage(int l) { return (l + 1) / 2; }
// the lane whose output of the step before is lane l's input
AFK_HD int cl_lane_source(int l) { return l <= 2 ? 0 : 1; }

struct CleanupLane {
    double c[5];
    double z1, z2;
    double hold1, hold2;  // the state as given
    double strength;      // a notch's first lane: the mix
    double done, total, rcp;
    bool mixes;   // a notch's first lane
    bool fading;  // its notch's crossfade is in flight
    bool held;    // a pending lane without one: stores the state as given
};

// fin: the stream's column of the CF_* rows (row pitch ss); coeffs, z,
// remaining: the stream's leaves of the hum and the harmonic notch.
AFK_HD void cl_lane_load(CleanupLane& L, int l, const float* fin, int ss,
                         const float* hum_c, const float* harm_c, const double* hum_z,
                         const double* harm_z, int hum_remaining, int harm_remaining,
                         const CleanupConsts& k) {
    L = CleanupLane{};
    if (l == 0) {
        // y = x - x1 + dc y1 in DF2T form: y = x + z1, z1' = dc y - x
        L.c[0] = 1.0;
        L.c[1] = -1.0;
        L.c[3] = -k.dc_coeff;
        L.z1 = k.dc_coeff * (double)fin[CF_DC_Y1 * ss] - (double)fin[CF_DC_X1 * ss];
    } else if (l < CL_USED_LANES) {
        const bool hum = l <= 2;
        const int p = (l - 1) % 2;
        const float* c = (hum ? hum_c : harm_c) + p * 5;
        const double* z = (hum ? hum_z : harm_z) + p * 2;
        const int remaining = hum ? hum_remaining : harm_remaining;
#pragma unroll
        for (int i = 0; i < 5; ++i) L.c[i] = (double)c[i];
        L.z1 = z[0];
        L.z2 = z[1];
        L.mixes = p == 0;
        L.fading = remaining > 0;
        L.held = p == 1 && !L.fading;
        L.strength =
            (double)afk_clip(fin[(hum ? CF_HUM_STRENGTH : CF_HARM_STRENGTH) * ss], 0.0f, 1.0f);
        L.total = (double)k.fade_total;
        L.done = (double)(k.fade_total - remaining) + 1.0;
        L.rcp = 1.0 / L.total;
    }
    L.hold1 = L.z1;
    L.hold2 = L.z2;
}

// The crossfade weights of a notch's first lane (stage `stage`) for the
// steps k0 .. k0+3 of a chunk that starts at block index c0 (step k filters
// the block's sample c0 + k - stage). Left at 1 where nothing blends.
AFK_HD void cl_group_weights(const CleanupLane& L, int k0, int stage, int c0,
                             double w[CL_GROUP]) {
#pragma unroll
    for (int j = 0; j < CL_GROUP; ++j) w[j] = 1.0;
    if (!L.mixes || !L.fading) return;
    const double n0 = L.done + (double)(c0 + k0 - stage);
#pragma unroll
    for (int j = 0; j < CL_GROUP; ++j)
        w[j] = fmin(fmax(afk_quotient(n0 + (double)j, L.total, L.rcp), 0.0), 1.0);
}

// One sample through the lane's section; commits the state where `valid`
// (CHECK false: always). The f64 chain is written in fma: a step is one
// operation from the lane's input to its output, and -fmad=false (for the
// detector's f32 roundings) leaves explicit fma alone.
template <bool CHECK>
AFK_HD double cl_lane_filter(CleanupLane& L, double in, bool valid) {
    const double y = fma(L.c[0], in, L.z1);
    const double z1 = fma(-L.c[3], y, fma(L.c[1], in, L.z2));
    const double z2 = fma(-L.c[4], y, L.c[2] * in);
    L.z1 = (!CHECK || valid) ? z1 : L.z1;
    L.z2 = (!CHECK || valid) ? z2 : L.z2;
    return y;
}

// The lane's output of the step: a notch's first lane blends its output y
// with the pending lane's (ya, weight w) while fading and mixes the result
// with its input by the strength; the other lanes pass y on. FADE false
// leaves out the blend, for lanes none of which fades.
template <bool FADE>
AFK_HD double cl_lane_mix(const CleanupLane& L, double in, double y, double ya, double w) {
    double out = y;
    if (FADE) out = L.fading ? fma(ya - y, w, y) : y;
    return L.mixes ? fma(out - in, L.strength, in) : y;
}

// Whether every stage's sample of steps k0 .. k0+3 lies in the chunk.
AFK_HD bool cl_group_steady(int k0, int tc) {
    return k0 >= CL_STAGES - 1 && k0 + CL_GROUP <= tc;
}

// z_out: the lane's (z1, z2) of its notch's [2, 2] state.
AFK_HD void cl_lane_store(const CleanupLane& L, double* z_out) {
    z_out[0] = L.held ? L.hold1 : L.z1;
    z_out[1] = L.held ? L.hold2 : L.z2;
}

#ifdef __CUDACC__
// The barrier of the warps that run the rumble detector.
__device__ __forceinline__ void cl_rumble_barrier() {
    __syncwarp();
    asm volatile("bar.sync 1, %0;" ::"n"(CL_RUMBLE_THREADS) : "memory");
}

// Steps k0 .. k0+3 of the wavefront for lane l of a stream.
template <bool FADE, bool CHECK>
__device__ __forceinline__ void cl_group(CleanupLane& L, double& v, const float* xs,
                                         const double* w, int k0, int l, bool on, int tc,
                                         float* yrow) {
    const int stage = cl_lane_stage(l), src = cl_lane_source(l);
#pragma unroll
    for (int j = 0; j < CL_GROUP; ++j) {
        const double up = __shfl_sync(0xffffffffu, v, src, CL_LANES);
        const double in = stage > 0 ? up : (double)xs[j];
        const int t = k0 + j - stage;
        const bool valid = !CHECK || (on && t >= 0 && t < tc);
        const double y = cl_lane_filter<CHECK>(L, in, valid);
        double ya = y;
        if (FADE) ya = __shfl_down_sync(0xffffffffu, y, 1, CL_LANES);
        const double out = cl_lane_mix<FADE>(L, in, y, ya, w[j]);
        v = valid ? out : v;
        if (valid && l == CL_LAST_MIX) yrow[t] = (float)out;
    }
}

// The wavefront over one staged chunk for lane l of a stream.
template <bool FADE>
__device__ __forceinline__ void cl_wave_chunk(CleanupLane& L, double& v, const float* xrow,
                                              float* yrow, int l, bool on, int c0, int tc) {
    // x[kb .. kb+3], read a group ahead; every lane reads (lane 0 uses it),
    // and reads past tc stay inside the padded row
    float4 cur = *reinterpret_cast<const float4*>(xrow);
    for (int kb = 0; kb < tc + CL_STAGES - 1; kb += CL_GROUP) {
        const float4 nxt = *reinterpret_cast<const float4*>(
            xrow + afk_imin(kb + CL_GROUP, (tc - 1) & ~3));
        const float xs[CL_GROUP] = {cur.x, cur.y, cur.z, cur.w};
        double w[CL_GROUP] = {1.0, 1.0, 1.0, 1.0};
        if (FADE) cl_group_weights(L, kb, cl_lane_stage(l), c0, w);
        if (cl_group_steady(kb, tc))
            cl_group<FADE, false>(L, v, xs, w, kb, l, on, tc, yrow);
        else
            cl_group<FADE, true>(L, v, xs, w, kb, l, on, tc, yrow);
        cur = nxt;
    }
}

__global__ void __launch_bounds__(CL_THREADS, 1)
cleanup_scan_kernel(const float* __restrict__ x, const float* __restrict__ fin,
                    const float* __restrict__ hum_c, const float* __restrict__ harm_c,
                    const double* __restrict__ hum_z, const double* __restrict__ harm_z,
                    const int* __restrict__ iin, float* __restrict__ y,
                    float* __restrict__ fout, double* __restrict__ hum_zout,
                    double* __restrict__ harm_zout, int* __restrict__ iout, int N, int T,
                    int tc_max, int stride, CleanupConsts k) {
    extern __shared__ __align__(16) float tile[];  // [KR_ROWS][CL_STREAMS][stride]
    float* fs = tile + KR_ROWS * CL_STREAMS * stride;              // [CF_RUMBLE][CL_STREAMS]
    int* ci = reinterpret_cast<int*>(fs + CF_RUMBLE * CL_STREAMS);  // [CI_COUNT][CL_STREAMS]
    int* t_last = ci + CI_COUNT * CL_STREAMS;                       // [CL_STREAMS]
    const int n0 = blockIdx.x * CL_STREAMS;
    const int rows = afk_imin(CL_STREAMS, N - n0);
    for (int i = threadIdx.x; i < CI_COUNT * CL_STREAMS; i += CL_THREADS) {
        const int key = i / CL_STREAMS, g = i % CL_STREAMS;
        if (g >= rows) continue;
        const long long at = (long long)key * N + n0 + g;
        ci[i] = iin[at];
        if (key < CF_RUMBLE) fs[i] = fin[at];
        if (key == 0) t_last[g] = -1;
    }
    // the first two warps: lane l of stream g of the wavefront
    const bool wave = threadIdx.x < CL_WAVE_THREADS;
    const int g = (threadIdx.x / CL_LANES) % CL_STREAMS, l = threadIdx.x % CL_LANES;
    const bool on = wave && g < rows && l < CL_USED_LANES;
    const long long n = n0 + g;
    CleanupLane L = {};
    if (on)
        cl_lane_load(L, l, fin + n, N, hum_c + n * 10, harm_c + n * 10, hum_z + n * 4,
                     harm_z + n * 4, iin[(long long)CI_FADE_HUM * N + n],
                     iin[(long long)CI_FADE_HARM * N + n], k);
    // a warp none of whose notches fades (the steady state) never blends
    const bool fade = __any_sync(0xffffffffu, L.fading);
    double v = 0.0;
    // the other warps: warp 2 and 3 run the detector's recurrences, lane g
    // stream g's; all of them its feed-forward phase
    const int warp = threadIdx.x / 32, rl = threadIdx.x % 32;
    const bool serial = rl < rows;

    for (int c0 = 0; c0 < T; c0 += tc_max) {
        const int tc = afk_imin(tc_max, T - c0);
        // ends with a block barrier: the streams' tables are in place too
        afk_tile_load(tile, stride, x + (long long)n0 * T, rows, T, c0, tc);
        if (wave) {
            const float* xrow = cl_row(tile, stride, KR_X, g);
            float* yrow = cl_row(tile, stride, KR_Y, g);
            if (fade)
                cl_wave_chunk<true>(L, v, xrow, yrow, l, on, c0, tc);
            else
                cl_wave_chunk<false>(L, v, xrow, yrow, l, on, c0, tc);
        } else {
            if (warp == 2 && serial) cl_phase_lowpass(tile, stride, rl, tc, fs, k);  // A
            if (warp == 3 && serial) cl_phase_broad(tile, stride, rl, tc, fs);
            cl_rumble_barrier();
            if (warp == 2 && serial) cl_phase_low(tile, stride, rl, tc, fs);  // B
            if (warp == 3 && serial) cl_phase_slow(tile, stride, rl, tc, fs);
            cl_rumble_barrier();
            // C: the trigger of every sample, the last one that fires
            for (int i = threadIdx.x - CL_WAVE_THREADS; i < rows * tc; i += CL_RUMBLE_THREADS) {
                const int gi = i / tc, t = i - gi * tc;
                if (cl_sample_trigger(tile, stride, gi, t, c0 + t, ci, k))
                    atomicMax(&t_last[gi], c0 + t);
            }
        }
        // starts and ends with a block barrier
        afk_tile_store(cl_row(tile, stride, KR_Y, 0), stride, y + (long long)n0 * T, rows, T, c0,
                       tc);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < CF_RUMBLE * CL_STREAMS; i += CL_THREADS) {
        const int key = i / CL_STREAMS, gi = i % CL_STREAMS;
        if (gi < rows) fout[(long long)key * N + n0 + gi] = fs[i];
    }
    if (threadIdx.x < rows)
        iout[n0 + threadIdx.x] =
            cl_rumble_hold_end(ci[cl_at(CI_RUMBLE_HOLD, threadIdx.x)], t_last[threadIdx.x], T,
                               k.rumble_hold_set);
    if (!on) return;
    if (l == 0) {
        // the blocker's x1 is the block's last sample, its y1 its last output
        const long long x1_at = (long long)CF_DC_X1 * N + n, y1_at = (long long)CF_DC_Y1 * N + n;
        fout[x1_at] = T > 0 ? x[n * T + T - 1] : fin[x1_at];
        fout[y1_at] = T > 0 ? (float)v : fin[y1_at];
    } else {
        double* z_out = (l <= 2 ? hum_zout : harm_zout) + n * 4 + ((l - 1) % 2) * 2;
        cl_lane_store(L, z_out);
    }
}

AFK_API int afk_cleanup_scan(const float* x, const float* fin, const float* hum_c,
                             const float* harm_c, const double* hum_z, const double* harm_z,
                             const int* iin, float* y, float* fout, double* hum_zout,
                             double* harm_zout, int* iout, int N, int T, float lp_c,
                             float env_thr, float burst_thr, int rumble_hold_set,
                             int fade_total, double dc_coeff, void* stream) {
    if (T < 0 || fade_total < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (N <= 0) return 0;
    const CleanupConsts k{lp_c, env_thr, burst_thr, rumble_hold_set, fade_total, dc_coeff};
    const int tc_max = afk_imax(afk_tile_chunk(T, KR_ROWS * CL_STREAMS, CL_TILE_SMEM_BYTES), 4);
    const int stride = afk_tile_stride(tc_max);
    const size_t smem = sizeof(float) * (KR_ROWS * CL_STREAMS * stride
                                         + (CF_RUMBLE + CI_COUNT + 1) * CL_STREAMS);
    static size_t allowed = 0;
    const int err = afk_allow_smem(cleanup_scan_kernel, smem, allowed);
    if (err != 0) return err;
    cleanup_scan_kernel<<<(N + CL_STREAMS - 1) / CL_STREAMS, CL_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        x, fin, hum_c, harm_c, hum_z, harm_z, iin, y, fout, hum_zout, harm_zout, iout, N, T,
        tc_max, stride, k);
    return static_cast<int>(cudaGetLastError());
}
#endif

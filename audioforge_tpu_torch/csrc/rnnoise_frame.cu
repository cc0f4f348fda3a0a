// rnnoise_pitch and rnnoise_features: the RNNoise frame's pitch tracker and
// feature tail, one launch each a frame.
//
// Replaces what XLA compiled on the TPU for `audioforge_tpu/models/rnnoise.py`
// `frame_features` (no Pallas kernel): `_pitch_downsample` (`:488`),
// `_lpc4` (`:463`), `_pitch_search` (`:535`) with `_find_best_pitch`
// (`:438`), `_remove_doubling` (`:581`), and the band energies, DCTs,
// `_spectral_floor` (`:715`) and cepstral memory of `frame_features`
// (`:732`). In the port these were some 1,050 eager operations over [N]
// tensors a frame, each a graph node of about 2 us, and two grouped conv1d
// on cuDNN; the twins `rnnoise_pitch_plain` and `rnnoise_features_plain` in
// `models/rnnoise.py` keep that arithmetic for CPU tensors.
//
// rnnoise_pitch, one block of 256 threads a stream, everything in shared
// memory: the new pitch buffer (1,728 samples, also written out); the 2x
// decimation and the lag-0..4 autocorrelation; the lag window, order-4
// Levinson with the twin's freeze mask and the whitening taps on one
// thread; the 5-tap whitening FIR, giving x24 [864]; the running sums of
// squares the scores and the doubling check read, as block scans; the 12
// kHz correlation (193 lags x 240 taps, 169 read) and the 24 kHz row (385
// lags x 480 taps, all of them, which remove_doubling reads), a lag a
// thread; the coarse top two and the fine best as block reductions over
// (score, lag) ordered as argmax orders them; remove_doubling's 14
// sub-period probes on the lanes of one warp, the last that passes found
// by a ballot (a probe's test reads nothing the probes before it chose);
// then the pitch-delayed frame, windowed, for the P spectrum's FFT.
// remove_doubling's cross-check multiples come from the caller's table.
//
// rnnoise_features, one warp a stream (four a block) from the X and P
// spectra: per-bin powers and cross products in shared memory, the 22
// triangular band sums a lane each, Exp, the silence flag, log10 and the
// 22-step spectral floor on one lane, both DCTs, the cepstral memory's
// shift, the 8 x 8 distance minimum and the variability; the 42 features.
// The band edges and weights, the DCT and its offsets come from the
// caller's tables (models/rnnoise.py _consts), the one place they are set.
//
// Bound: operations, the correlations' 231,120 multiply-adds a stream
// (bench_torch/counts rnnoise_macs); 0.0071 ms at fleet 1024 at the f32
// peak. Both sources build with -fmad=false, so every product and sum
// rounds as the twins' elementwise operations round them and the integer
// pitch decisions follow the twin's; the correlations are written as fused
// multiply-adds (their sums run in another order than the twin's conv1d in
// any case), and the reductions of squares and band sums add f32 terms in
// f64 and round once, close to the twin's f32 sums.
#include "afk.cuh"

constexpr int RNP_FRAME = 480;
constexpr int RNP_WIN = 960;
constexpr int RNP_BUF = 1728;              // PITCH_BUF_SIZE
constexpr int RNP_HALF = RNP_BUF / 2;      // x24, the buffer at 24 kHz
constexpr int RNP_MAXP = 384;              // PITCH_MAX_PERIOD / 2
constexpr int RNP_MINP = 30;               // PITCH_MIN_PERIOD / 2
constexpr int RNP_N24 = 480;               // fine taps (the frame at 24 kHz)
constexpr int RNP_N12 = 240;               // coarse taps
constexpr int RNP_Y12 = RNP_HALF / 2;      // y4, x24 decimated: 432
constexpr int RNP_LAGS12 = RNP_Y12 - RNP_N12 + 1;   // 193 computed
constexpr int RNP_USE12 = 169;             // max_pitch / 4 read
constexpr int RNP_LAGS24 = RNP_MAXP + 1;   // 385
constexpr int RNP_USE24 = 339;             // max_pitch / 2
constexpr int RNP_PROBES = 14;             // sub-periods k = 2 .. 15
constexpr int RNP_THREADS = 256;
constexpr int RNP_WARPS = RNP_THREADS / 32;
static_assert(RNP_HALF <= 4 * RNP_THREADS, "a scan thread sums four elements");

// ---------------------------------------------------------------------------
// rnnoise_pitch: per-stream phases
// ---------------------------------------------------------------------------

// x_lp[i]: the [.25 .5 .25] decimation by 2.
AFK_HD float rnp_decimate(const float* buf, int i) {
    const float left = i > 0 ? buf[2 * i - 1] : 0.0f;
    return (0.25f * left + 0.5f * buf[2 * i]) + 0.25f * buf[2 * i + 1];
}

// Sample i's terms of the lag-0..4 autocorrelation of x_lp: each product
// rounded to f32, as the twin's elementwise product, and added in f64.
AFK_HD void rnp_ac_add(const float* xlp, int i, double (&acc)[5]) {
#pragma unroll
    for (int k = 0; k < 5; ++k)
        if (i + k < RNP_HALF) acc[k] += static_cast<double>(xlp[i] * xlp[i + k]);
}

// The lag window, order-4 Levinson-Durbin (the early exit as the twin's
// freeze mask), the 0.9^k bandwidth expansion and the five whitening taps.
AFK_HD void rnp_lpc_taps(const float (&ac_in)[5], const float* lagw, const float* decay,
                         float (&taps)[5]) {
    float ac[5];
    ac[0] = (ac_in[0] * 1.0001f) * lagw[0];
#pragma unroll
    for (int k = 1; k < 5; ++k) ac[k] = ac_in[k] * lagw[k];
    float lpc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float error = ac[0];
    bool alive = ac[0] != 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float rr = ac[i + 1];
#pragma unroll
        for (int j = 0; j < i; ++j) rr = rr + lpc[j] * ac[i - j];
        const float r = -rr / (error == 0.0f ? 1.0f : error);
        float upd[4] = {lpc[0], lpc[1], lpc[2], lpc[3]};
        upd[i] = r;
#pragma unroll
        for (int j = 0; j < (i + 1) / 2; ++j) {
            const float t1 = lpc[j], t2 = lpc[i - 1 - j];
            upd[j] = t1 + r * t2;
            upd[i - 1 - j] = t2 + r * t1;
        }
        const float new_error = error - (r * r) * error;
        if (alive) {
#pragma unroll
            for (int j = 0; j < 4; ++j) lpc[j] = upd[j];
            error = new_error;
        }
        alive = alive && (error >= 0.001f * ac[0]);
    }
    float l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) l[k] = lpc[k] * decay[k];
    taps[0] = l[0] + 0.8f;
    taps[1] = l[1] + 0.8f * l[0];
    taps[2] = l[2] + 0.8f * l[1];
    taps[3] = l[3] + 0.8f * l[2];
    taps[4] = 0.8f * l[3];
}

// x24[i]: the whitening FIR over x_lp, zeros before its start.
AFK_HD float rnp_whiten(const float* xlp, const float (&taps)[5], int i) {
    float acc = xlp[i];
#pragma unroll
    for (int k = 0; k < 5; ++k) acc = acc + taps[k] * (i - k - 1 >= 0 ? xlp[i - k - 1] : 0.0f);
    return acc;
}

// The sum of x[j] y[j] over len taps (a multiple of 4, x 16-byte aligned):
// tap j into partial sum j % 4, each a chain of fused multiply-adds, then
// the partial sums added in pairs.
AFK_HD float rnp_xcorr(const float* x, const float* y, int len) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int j = 0; j < len; j += 4) {
        const float4 xv = afk_load4(x + j);
        a0 = fmaf(xv.x, y[j], a0);
        a1 = fmaf(xv.y, y[j + 1], a1);
        a2 = fmaf(xv.z, y[j + 2], a2);
        a3 = fmaf(xv.w, y[j + 3], a3);
    }
    return (a0 + a1) + (a2 + a3);
}

// _find_best_pitch's energy of the len samples at lag i, from the running
// sums of squares (csum[0] = 0), and the lag's score.
AFK_HD float rnp_syy(const float* csum, int i, int len) {
    return fmaxf((1.0f + csum[i + len]) - csum[i], 1.0f);
}

AFK_HD float rnp_score(float xcorr, float syy) {
    return xcorr > 0.0f ? (xcorr * xcorr) / syy : -1.0f;
}

// The two best (score, lag) pairs in argmax's order: the higher score first,
// on a tie the lower lag. Scores are at least -1, so the sentinel is below
// any of them.
struct RnpTop2 {
    float s0;
    int i0;
    float s1;
    int i1;
};

AFK_HD RnpTop2 rnp_top2_empty() { return {-3.0f, 1 << 30, -3.0f, 1 << 30}; }

AFK_HD bool rnp_before(float s, int i, float t, int j) { return s > t || (s == t && i < j); }

AFK_HD void rnp_top2_push(RnpTop2& r, float s, int i) {
    if (rnp_before(s, i, r.s0, r.i0)) {
        r.s1 = r.s0;
        r.i1 = r.i0;
        r.s0 = s;
        r.i0 = i;
    } else if (rnp_before(s, i, r.s1, r.i1)) {
        r.s1 = s;
        r.i1 = i;
    }
}

AFK_HD void rnp_top2_merge(RnpTop2& r, const RnpTop2& o) {
    rnp_top2_push(r, o.s0, o.i0);
    rnp_top2_push(r, o.s1, o.i1);
}

// The coarse search's two candidates: argmax and the argmax without it, or
// (0, 1) when no lag correlates positively.
AFK_HD void rnp_coarse_pick(const RnpTop2& top, int* c0, int* c1) {
    const bool any = top.s0 > -1.0f;
    *c0 = any ? top.i0 : 0;
    *c1 = any ? top.i1 : 1;
}

// xc24 of the fine search at lag: the correlation, floored at -1, within two
// lags of a doubled coarse candidate, else 0.
AFK_HD float rnp_fine_value(const float* ext, int lag, int c0, int c1) {
    const int d0 = lag - 2 * c0, d1 = lag - 2 * c1;
    const bool near = (d0 >= -2 && d0 <= 2) || (d1 >= -2 && d1 <= 2);
    return near ? fmaxf(ext[lag], -1.0f) : 0.0f;
}

// The pseudo-interpolation's step from the correlations a, b, c at the
// lags before, at and after the best.
AFK_HD int rnp_interp_offset(float a, float b, float c) {
    return (c - a) > 0.7f * (b - a) ? 1 : ((a - c) > 0.7f * (b - c) ? -1 : 0);
}

// pitch_search's result (a lag in 48 kHz units) from the fine search's best
// (b0 = 0 when nothing correlated positively).
AFK_HD int rnp_raw_index(const float* ext, const RnpTop2& fine, int c0, int c1) {
    const int b0 = fine.s0 > -1.0f ? fine.i0 : 0;
    if (b0 <= 0 || b0 >= RNP_USE24 - 1) return 2 * b0;
    return 2 * b0 - rnp_interp_offset(rnp_fine_value(ext, b0 - 1, c0, c1),
                                      rnp_fine_value(ext, b0, c0, c1),
                                      rnp_fine_value(ext, b0 + 1, c0, c1));
}

AFK_HD int rnp_floor_div(int a, int b) {
    const int q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// remove_doubling's period at 24 kHz from pitch_search's lag.
AFK_HD int rnp_t0(int raw_index) {
    return afk_imin(rnp_floor_div(2 * RNP_MAXP - raw_index, 2), RNP_MAXP - 1);
}

AFK_HD float rnp_pitch_gain(float xy, float xx, float yy) {
    return xy / sqrtf(1.0f + xx * yy);
}

// The energy of the frame's samples delayed by period p: xx plus the running
// sum of back^2 - fwd^2 (cs[0] = 0), floored at 0.
AFK_HD float rnp_yy(float xx, const float* cs, int p) { return fmaxf(xx + cs[p], 0.0f); }

struct RnpProbe {
    bool take;
    int T1;
    float xy, yy, g1;
};

// Sub-period k of remove_doubling: its period T1, the averaged correlation
// and energy with the cross-check period (second: the table's multiple, for
// k > 2), the gain and whether it passes the continuity thresholds. Nothing
// here reads what an earlier k chose, so the kernel runs the 14 on the lanes
// of a warp and keeps the last that passes.
AFK_HD RnpProbe rnp_probe(int k, int second, int T0, int prev_period, float prev_gain, float g0,
                          float xx, const float* corr, const float* cs) {
    const int T1 = (2 * T0 + k) / (2 * k);
    const int T1b = k == 2 ? (T1 + T0 > RNP_MAXP ? T0 : T0 + T1) : (2 * second * T0 + k) / (2 * k);
    const int p1 = afk_imin(afk_imax(T1, 0), RNP_MAXP);
    const int p2 = afk_imin(afk_imax(T1b, 0), RNP_MAXP);
    RnpProbe p;
    p.T1 = T1;
    p.xy = 0.5f * (corr[RNP_MAXP - p1] + corr[RNP_MAXP - p2]);
    p.yy = 0.5f * (rnp_yy(xx, cs, p1) + rnp_yy(xx, cs, p2));
    p.g1 = rnp_pitch_gain(p.xy, xx, p.yy);
    const int dist = T1 > prev_period ? T1 - prev_period : prev_period - T1;
    const float cont = dist <= 1 ? prev_gain
                                 : ((dist <= 2 && 5 * k * k < T0) ? 0.5f * prev_gain : 0.0f);
    float thresh = fmaxf(0.7f * g0 - cont, 0.3f);
    if (T1 < 2 * RNP_MINP)
        thresh = fmaxf(0.9f * g0 - cont, 0.5f);
    else if (T1 < 3 * RNP_MINP)
        thresh = fmaxf(0.85f * g0 - cont, 0.4f);
    p.take = T1 >= RNP_MINP && p.g1 > thresh;
    return p;
}

// remove_doubling's end from the chosen (xy, yy, T, g): the gain and the
// pitch-interpolated period in 48 kHz units.
AFK_HD void rnp_doubling_finish(float best_xy, float best_yy, int T, float g, const float* corr,
                                int* period, float* gain) {
    best_xy = fmaxf(best_xy, 0.0f);
    const float pg = best_yy <= best_xy ? 1.0f : best_xy / (best_yy + best_xy);
    const int Ts = afk_imin(afk_imax(T, 1), RNP_MAXP - 1);
    const int offset = rnp_interp_offset(corr[RNP_MAXP - (Ts - 1)], corr[RNP_MAXP - Ts],
                                         corr[RNP_MAXP - (Ts + 1)]);
    *gain = fminf(pg, g);
    *period = afk_imax(2 * T + offset, 2 * RNP_MINP);
}

// ---------------------------------------------------------------------------
// rnnoise_features: per-stream phases
// ---------------------------------------------------------------------------

constexpr int RNF_FREQ = 481;
constexpr int RNF_BANDS = 22;
constexpr int RNF_BAND_BINS = 400;   // the last band edge: bins above it weigh nothing
constexpr int RNF_MEM = 8;
constexpr int RNF_DELTA = 6;
constexpr int RNF_FEATURES = 42;
constexpr int RNF_WARPS = 4;         // streams a block

AFK_HD float rnf_power(float re, float im) { return re * re + im * im; }

AFK_HD float rnf_cross(float xr, float xi, float pr, float pi) { return xr * pr + xi * pi; }

// Band b's triangular sum of q over its two half-bands between the band
// edges (in bins): w[bin] is a bin's weight for the band at the start of its
// segment, w[RNF_BAND_BINS + bin] for the band at its end (the twin's band
// matrix in f32). The products of two f32 values are exact in f64, so each
// fused multiply-add rounds only the sum.
AFK_HD float rnf_band(const float* q, const float* w, const int* edge, int b) {
    double acc = 0.0;
    if (b > 0)
        for (int k = edge[b - 1]; k < edge[b]; ++k)
            acc = fma(static_cast<double>(w[RNF_BAND_BINS + k]), static_cast<double>(q[k]), acc);
    if (b < RNF_BANDS - 1)
        for (int k = edge[b]; k < edge[b + 1]; ++k)
            acc = fma(static_cast<double>(w[k]), static_cast<double>(q[k]), acc);
    return static_cast<float>(acc);
}

AFK_HD float rnf_exp(float num, float ex, float ep) { return num / sqrtf(0.001f + ex * ep); }

AFK_HD float rnf_log_energy(float ex) { return log10f(0.01f + ex); }

// One band of _spectral_floor (log_max and follow start at -2).
AFK_HD float rnf_floor_step(float le, float& log_max, float& follow) {
    const float ly = fmaxf(log_max - 7.0f, fmaxf(follow - 1.5f, le));
    log_max = fmaxf(log_max, ly);
    follow = fmaxf(follow - 1.5f, ly);
    return ly;
}

// Row k of the band DCT of v (dct_t [22, 22], the twin's transposed matrix).
AFK_HD float rnf_dct(const float* v, const float* dct_t, int k) {
    double acc = 0.0;
    for (int j = 0; j < RNF_BANDS; ++j)
        acc = fma(static_cast<double>(v[j]), static_cast<double>(dct_t[j * RNF_BANDS + k]), acc);
    return static_cast<float>(acc);
}

// Band k's features from the new cepstrum c0, the last two c1, c2 and the
// pitch correlation's DCT row pc.
AFK_HD void rnf_feature_rows(int k, float c0, float c1, float c2, float pc, float* feat) {
    feat[k] = k < RNF_DELTA ? (c0 + c1) + c2 : c0;
    if (k < RNF_DELTA) {
        feat[RNF_BANDS + k] = c0 - c2;
        feat[RNF_BANDS + RNF_DELTA + k] = (c0 - 2.0f * c1) + c2;
        feat[RNF_BANDS + 2 * RNF_DELTA + k] = pc;
    }
}

AFK_HD float rnf_pitch_feature(int pitch_index) {
    return 0.01f * static_cast<float>(pitch_index - 300);
}

// Pair p < 28 of the cepstral memory's rows as (i, j), i < j.
AFK_HD void rnf_pair(int p, int* i, int* j) {
    int a = 0;
    while (p >= RNF_MEM - 1 - a) {
        p -= RNF_MEM - 1 - a;
        ++a;
    }
    *i = a;
    *j = a + 1 + p;
}

// Squared distance of rows i and j of the memory [8, 22].
AFK_HD float rnf_dist(const float* rows, int i, int j) {
    double acc = 0.0;
    for (int k = 0; k < RNF_BANDS; ++k) {
        const float d = rows[i * RNF_BANDS + k] - rows[j * RNF_BANDS + k];
        acc += static_cast<double>(d * d);
    }
    return static_cast<float>(acc);
}

// The mean of the rows' nearest distances, less 2.1.
AFK_HD float rnf_variability(const float* row_min) {
    double s = 0.0;
    for (int i = 0; i < RNF_MEM; ++i) s += static_cast<double>(row_min[i]);
    return static_cast<float>(s) / 8.0f - 2.1f;
}

// Term i of running sum a: x24 at 12 kHz squared (a = 0), x24 squared
// (a = 1), and the energy's change as the period grows past i (a = 2).
AFK_HD double rnp_square_term(const float* x24, int a, int i) {
    if (a == 0) return static_cast<double>(x24[2 * i] * x24[2 * i]);
    if (a == 1) return static_cast<double>(x24[i] * x24[i]);
    const float b = x24[RNP_MAXP - 1 - i], f = x24[RNP_HALF - 1 - i];
    return static_cast<double>(b * b - f * f);
}

#ifdef __CUDACC__
constexpr unsigned RNP_FULL = 0xffffffffu;

// The block's sums of each thread's v[0 .. NV-1], in thread 0's v (the
// warps' sums added in warp order). Ends with the block synchronised.
template <int NV>
__device__ __forceinline__ void rnp_block_sum(double (&v)[NV], double* part) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < NV; ++q)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v[q] += __shfl_xor_sync(RNP_FULL, v[q], off);
    if (lane == 0)
#pragma unroll
        for (int q = 0; q < NV; ++q) part[w * NV + q] = v[q];
    __syncthreads();
    if (threadIdx.x == 0)
#pragma unroll
        for (int q = 0; q < NV; ++q) {
            double s = part[q];
            for (int u = 1; u < RNP_WARPS; ++u) s += part[u * NV + q];
            v[q] = s;
        }
}

// out[a][i + 1] = the f64 sum of rnp_square_term(x24, a, 0 .. i) rounded to
// f32, out[a][0] = 0, for i < len[a]: thread t sums elements 4t .. 4t+3, a
// warp scans its threads' sums, then the warps' totals are added in warp
// order.
template <int NA>
__device__ __forceinline__ void rnp_block_cumsum(const float* x24, const int (&len)[NA],
                                                 float* const (&out)[NA], double (*tot)[NA]) {
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    double loc[NA][4], incl[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
        double s = 0.0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = 4 * t + r;
            if (i < len[a]) s += rnp_square_term(x24, a, i);
            loc[a][r] = s;
        }
        incl[a] = s;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const double u = __shfl_up_sync(RNP_FULL, incl[a], off);
            if (lane >= off) incl[a] += u;
        }
        if (lane == 31) tot[w][a] = incl[a];
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < NA; ++a) {
        double base = __shfl_up_sync(RNP_FULL, incl[a], 1);
        if (lane == 0) base = 0.0;
        for (int u = 0; u < w; ++u) base += tot[u][a];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = 4 * t + r;
            if (i < len[a]) out[a][i + 1] = static_cast<float>(base + loc[a][r]);
        }
        if (t == 0) out[a][0] = 0.0f;
    }
    __syncthreads();
}

// The block's best two (score, lag) pairs, in thread 0: a butterfly in each
// warp, then the warps' pairs merged in warp order. Ends with the block
// synchronised.
__device__ __forceinline__ RnpTop2 rnp_block_top2(RnpTop2 r, RnpTop2* part) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        RnpTop2 o;
        o.s0 = __shfl_xor_sync(RNP_FULL, r.s0, off);
        o.i0 = __shfl_xor_sync(RNP_FULL, r.i0, off);
        o.s1 = __shfl_xor_sync(RNP_FULL, r.s1, off);
        o.i1 = __shfl_xor_sync(RNP_FULL, r.i1, off);
        rnp_top2_merge(r, o);
    }
    if (lane == 0) part[w] = r;
    __syncthreads();
    if (threadIdx.x == 0)
        for (int u = 1; u < RNP_WARPS; ++u) rnp_top2_merge(r, part[u]);
    __syncthreads();
    return r;
}

__global__ void __launch_bounds__(RNP_THREADS)
rnnoise_pitch_kernel(const float* __restrict__ pitch_buf, const float* __restrict__ x,
                     const int* __restrict__ last_period, const float* __restrict__ last_gain,
                     const float* __restrict__ lagw, const float* __restrict__ decay,
                     const int* __restrict__ second_check, const float* __restrict__ window,
                     float* __restrict__ pitch_buf_out,
                     int* __restrict__ pitch_index, float* __restrict__ gain_out,
                     float* __restrict__ p_frame) {
    __shared__ __align__(16) float buf[RNP_BUF];
    __shared__ __align__(16) float xlp[RNP_HALF];
    __shared__ __align__(16) float x24[RNP_HALF];
    __shared__ __align__(16) float x12[RNP_N12];
    __shared__ __align__(16) float y12[RNP_Y12];
    __shared__ float csum12[RNP_Y12 + 1], csum24[RNP_HALF + 1], cs_yy[RNP_MAXP + 1];
    __shared__ float xc12[RNP_LAGS12], ext[RNP_LAGS24];
    __shared__ double part[RNP_WARPS * 5];
    __shared__ double tot[RNP_WARPS][3];
    __shared__ RnpTop2 tops[RNP_WARPS];
    __shared__ float taps_s[5], xx_s;
    __shared__ int pick_s[3], period_s;
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const long long n = blockIdx.x;

    // every load first: the old buffer's last 1,248 samples and the frame,
    // 432 quads; remove_doubling's previous period and gain on warp 0
    constexpr int QUADS = RNP_BUF / 4, OLD_QUADS = (RNP_BUF - RNP_FRAME) / 4;
    const float4* old4 = reinterpret_cast<const float4*>(pitch_buf + n * RNP_BUF + RNP_FRAME);
    const float4* new4 = reinterpret_cast<const float4*>(x + n * RNP_FRAME);
    float4 v[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int q = t + r * RNP_THREADS;
        v[r] = q < OLD_QUADS ? old4[q]
                             : (q < QUADS ? new4[q - OLD_QUADS] : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    int prev48 = 0, second = 0;
    float prev_gain = 0.0f;
    if (w == 0) {
        prev48 = last_period[n];
        prev_gain = last_gain[n];
        if (lane < RNP_PROBES) second = second_check[lane];
    }
    float4* out4 = reinterpret_cast<float4*>(pitch_buf_out + n * RNP_BUF);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int q = t + r * RNP_THREADS;
        if (q < QUADS) {
            reinterpret_cast<float4*>(buf)[q] = v[r];
            out4[q] = v[r];
        }
    }
    __syncthreads();

    // decimation, autocorrelation, Levinson and the taps, whitening
    for (int i = t; i < RNP_HALF; i += RNP_THREADS) xlp[i] = rnp_decimate(buf, i);
    __syncthreads();
    double ac[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
    for (int i = t; i < RNP_HALF; i += RNP_THREADS) rnp_ac_add(xlp, i, ac);
    rnp_block_sum(ac, part);
    if (t == 0) {
        float acf[5], taps[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) acf[k] = static_cast<float>(ac[k]);
        rnp_lpc_taps(acf, lagw, decay, taps);
#pragma unroll
        for (int k = 0; k < 5; ++k) taps_s[k] = taps[k];
    }
    __syncthreads();
    float taps[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) taps[k] = taps_s[k];
    for (int i = t; i < RNP_HALF; i += RNP_THREADS) x24[i] = rnp_whiten(xlp, taps, i);
    __syncthreads();

    // the 12 kHz rows, the frame's energy, the running sums of squares
    for (int i = t; i < RNP_Y12; i += RNP_THREADS) {
        y12[i] = x24[2 * i];
        if (i < RNP_N12) x12[i] = x24[RNP_MAXP + 2 * i];
    }
    double e[1] = {0.0};
    for (int i = RNP_MAXP + t; i < RNP_HALF; i += RNP_THREADS)
        e[0] += static_cast<double>(x24[i] * x24[i]);
    rnp_block_sum(e, part);
    if (t == 0) xx_s = static_cast<float>(e[0]);
    const int lens[3] = {RNP_Y12, RNP_HALF, RNP_MAXP};
    float* const outs[3] = {csum12, csum24, cs_yy};
    rnp_block_cumsum<3>(x24, lens, outs, tot);

    // the correlations: the 24 kHz row's 385 lags, then the 12 kHz 193
    for (int u = t; u < RNP_LAGS24 + RNP_LAGS12; u += RNP_THREADS) {
        if (u < RNP_LAGS24)
            ext[u] = rnp_xcorr(x24 + RNP_MAXP, x24 + u, RNP_N24);
        else
            xc12[u - RNP_LAGS24] = rnp_xcorr(x12, y12 + (u - RNP_LAGS24), RNP_N12);
    }
    __syncthreads();

    // coarse search: the two best lags
    RnpTop2 top = rnp_top2_empty();
    for (int i = t; i < RNP_USE12; i += RNP_THREADS)
        rnp_top2_push(top, rnp_score(xc12[i], rnp_syy(csum12, i, RNP_N12)), i);
    top = rnp_block_top2(top, tops);
    if (t == 0) rnp_coarse_pick(top, &pick_s[0], &pick_s[1]);
    __syncthreads();
    const int c0 = pick_s[0], c1 = pick_s[1];

    // fine search near them, and the period it gives remove_doubling
    top = rnp_top2_empty();
    for (int i = t; i < RNP_USE24; i += RNP_THREADS)
        rnp_top2_push(top, rnp_score(rnp_fine_value(ext, i, c0, c1), rnp_syy(csum24, i, RNP_N24)),
                      i);
    top = rnp_block_top2(top, tops);
    if (t == 0) pick_s[2] = rnp_t0(rnp_raw_index(ext, top, c0, c1));
    __syncthreads();

    // remove_doubling: probe k = lane + 2 on warp 0, the last that passes
    if (w == 0) {
        const int T0 = pick_s[2];
        const float xx = xx_s;
        const int prev_period = rnp_floor_div(prev48, 2);
        const float xy0 = ext[RNP_MAXP - T0], yy0 = rnp_yy(xx, cs_yy, T0);
        const float g0 = rnp_pitch_gain(xy0, xx, yy0);
        RnpProbe p = {false, T0, xy0, yy0, g0};
        if (lane < RNP_PROBES)
            p = rnp_probe(lane + 2, second, T0, prev_period, prev_gain, g0, xx, ext, cs_yy);
        // the last probe that passes, if any
        const unsigned passed = __ballot_sync(RNP_FULL, p.take);
        const int src = passed ? 31 - __clz(passed) : 0;
        const float bxy = __shfl_sync(RNP_FULL, p.xy, src);
        const float byy = __shfl_sync(RNP_FULL, p.yy, src);
        const int T = __shfl_sync(RNP_FULL, p.T1, src);
        const float g = __shfl_sync(RNP_FULL, p.g1, src);
        if (lane == 0) {
            int period;
            float gain;
            rnp_doubling_finish(passed ? bxy : xy0, passed ? byy : yy0, passed ? T : T0,
                                passed ? g : g0, ext, &period, &gain);
            pitch_index[n] = period;
            gain_out[n] = gain;
            period_s = period;
        }
    }
    __syncthreads();

    // the pitch-delayed frame, windowed
    const int start = RNP_BUF - RNP_WIN - period_s;
    for (int j = t; j < RNP_WIN; j += RNP_THREADS)
        p_frame[n * RNP_WIN + j] = buf[start + j] * window[j];
}

__global__ void __launch_bounds__(32 * RNF_WARPS)
rnnoise_features_kernel(const float* __restrict__ X, const float* __restrict__ P,
                        const float* __restrict__ mem, const int* __restrict__ pitch_index,
                        const float* __restrict__ band_w, const int* __restrict__ band_edge,
                        const float* __restrict__ dct_t, const float* __restrict__ ceps_offset,
                        const float* __restrict__ pc_offset, float* __restrict__ features,
                        float* __restrict__ mem_out,
                        float* __restrict__ ex_out, float* __restrict__ ep_out,
                        float* __restrict__ exp_out, unsigned char* __restrict__ silence,
                        int N) {
    constexpr int LOADS = (RNF_FREQ + 31) / 32;
    __shared__ float weights[2 * RNF_BAND_BINS];
    __shared__ int edge[RNF_BANDS];
    __shared__ float q[RNF_WARPS][3][RNF_FREQ];
    __shared__ float vec[RNF_WARPS][2][RNF_BANDS];   // Exp, then the floored log energies
    __shared__ float rows[RNF_WARPS][RNF_MEM * RNF_BANDS];
    __shared__ float dist[RNF_WARPS][RNF_MEM * RNF_MEM];
    __shared__ float row_min[RNF_WARPS][RNF_MEM];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long n = static_cast<long long>(blockIdx.x) * RNF_WARPS + w;
    const bool live = n < N;

    // every load first: both spectra, the memory's first seven rows, the
    // pitch, the lane's offsets; the band weights and edges by the whole block
    const float2* X2 = reinterpret_cast<const float2*>(X) + n * RNF_FREQ;
    const float2* P2 = reinterpret_cast<const float2*>(P) + n * RNF_FREQ;
    float2 xv[LOADS], pv[LOADS];
#pragma unroll
    for (int m = 0; m < LOADS; ++m) {
        const int k = lane + 32 * m;
        const bool in = live && k < RNF_FREQ;
        xv[m] = in ? X2[k] : make_float2(0.0f, 0.0f);
        pv[m] = in ? P2[k] : make_float2(0.0f, 0.0f);
    }
    float old[RNF_MEM - 1];
#pragma unroll
    for (int i = 0; i < RNF_MEM - 1; ++i)
        old[i] = live && lane < RNF_BANDS ? mem[(n * RNF_MEM + i) * RNF_BANDS + lane] : 0.0f;
    const int pitch = live ? pitch_index[n] : 0;
    const float ceps_off = lane < RNF_BANDS ? ceps_offset[lane] : 0.0f;
    const float pc_off = lane < RNF_DELTA ? pc_offset[lane] : 0.0f;
    for (int k = threadIdx.x; k < 2 * RNF_BAND_BINS; k += 32 * RNF_WARPS) weights[k] = band_w[k];
    if (threadIdx.x < RNF_BANDS) edge[threadIdx.x] = band_edge[threadIdx.x];
#pragma unroll
    for (int m = 0; m < LOADS; ++m) {
        const int k = lane + 32 * m;
        if (k < RNF_FREQ) {
            q[w][0][k] = rnf_power(xv[m].x, xv[m].y);
            q[w][1][k] = rnf_power(pv[m].x, pv[m].y);
            q[w][2][k] = rnf_cross(xv[m].x, xv[m].y, pv[m].x, pv[m].y);
        }
    }
    __syncthreads();
    if (!live) return;

    // band energies, Exp, the log energies; the silence test on their sum
    const long long band_row = n * RNF_BANDS;
    float ex = 0.0f;
    if (lane < RNF_BANDS) {
        ex = rnf_band(q[w][0], weights, edge, lane);
        const float ep = rnf_band(q[w][1], weights, edge, lane);
        const float ratio = rnf_exp(rnf_band(q[w][2], weights, edge, lane), ex, ep);
        ex_out[band_row + lane] = ex;
        ep_out[band_row + lane] = ep;
        exp_out[band_row + lane] = ratio;
        vec[w][0][lane] = ratio;
        vec[w][1][lane] = rnf_log_energy(ex);
    }
    double energy = static_cast<double>(ex);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) energy += __shfl_xor_sync(RNP_FULL, energy, off);
    __syncwarp();
    if (lane == 0) {
        float log_max = -2.0f, follow = -2.0f;
        for (int i = 0; i < RNF_BANDS; ++i)
            vec[w][1][i] = rnf_floor_step(vec[w][1][i], log_max, follow);
    }
    __syncwarp();

    // cepstrum, the memory's shift, the features
    float* feat = features + n * RNF_FEATURES;
    if (lane < RNF_BANDS) {
        const float c0 = rnf_dct(vec[w][1], dct_t, lane) - ceps_off;
        const float pc = lane < RNF_DELTA ? rnf_dct(vec[w][0], dct_t, lane) - pc_off : 0.0f;
        rnf_feature_rows(lane, c0, old[0], old[1], pc, feat);
        rows[w][lane] = c0;
#pragma unroll
        for (int i = 1; i < RNF_MEM; ++i) rows[w][i * RNF_BANDS + lane] = old[i - 1];
#pragma unroll
        for (int i = 0; i < RNF_MEM; ++i)
            mem_out[(n * RNF_MEM + i) * RNF_BANDS + lane] = rows[w][i * RNF_BANDS + lane];
    }
    if (lane == 0) {
        feat[RNF_FEATURES - 2] = rnf_pitch_feature(pitch);
        silence[n] = static_cast<float>(energy) < 0.04f;
    }
    __syncwarp();

    // variability: the 28 distances, each row's nearest, their mean
    if (lane < RNF_MEM * (RNF_MEM - 1) / 2) {
        int i, j;
        rnf_pair(lane, &i, &j);
        const float d = rnf_dist(rows[w], i, j);
        dist[w][i * RNF_MEM + j] = d;
        dist[w][j * RNF_MEM + i] = d;
    }
    __syncwarp();
    if (lane < RNF_MEM) {
        float least = 3.0e38f;
        for (int j = 0; j < RNF_MEM; ++j)
            if (j != lane) least = fminf(least, dist[w][lane * RNF_MEM + j]);
        row_min[w][lane] = least;
    }
    __syncwarp();
    if (lane == 0) feat[RNF_FEATURES - 1] = rnf_variability(row_min[w]);
}

AFK_API int afk_rnnoise_pitch(const float* pitch_buf, const float* x, const int* last_period,
                              const float* last_gain, const float* lagw, const float* decay,
                              const int* second_check, const float* window,
                              float* pitch_buf_out, int* pitch_index, float* gain,
                              float* p_frame, int N, void* stream) {
    if (N > 0)
        rnnoise_pitch_kernel<<<N, RNP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            pitch_buf, x, last_period, last_gain, lagw, decay, second_check, window,
            pitch_buf_out, pitch_index, gain, p_frame);
    return static_cast<int>(cudaGetLastError());
}

AFK_API int afk_rnnoise_features(const float* X, const float* P, const float* mem,
                                 const int* pitch_index, const float* band_w,
                                 const int* band_edge, const float* dct_t,
                                 const float* ceps_offset, const float* pc_offset,
                                 float* features, float* mem_out, float* ex, float* ep,
                                 float* exp_out, unsigned char* silence, int N, void* stream) {
    if (N > 0)
        rnnoise_features_kernel<<<(N + RNF_WARPS - 1) / RNF_WARPS, 32 * RNF_WARPS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
            X, P, mem, pitch_index, band_w, band_edge, dct_t, ceps_offset, pc_offset, features,
            mem_out, ex, ep, exp_out, silence, N);
    return static_cast<int>(cudaGetLastError());
}
#endif

// biquad_cascade: S crossfaded dual-lane DF2T biquad sections in series,
// one lane per section, the sections of a stream run as a wavefront.
//
// Replaces the TPU path's per-section blocked associative scans
// (audioforge_tpu/ops/biquad.py:186 apply, :346 unit_process) that XLA ran for
// the EQ cascade (ops/eq.py:316), the K-weighting pair (ops/loudness.py:158),
// and the matmul form of the fixed DC blocker / 80 Hz high-pass / RNNoise
// input high-pass (ops/biquad.py:259 apply_fixed). The TPU needed double-word
// f32 for the low-frequency sections; here the state is native f64 like the
// reference's filters.
//
// Per sample and section, each crossfade lane runs
//   y = b0*x + z1;  z1' = b1*x - a1*y + z2;  z2' = b2*x - a2*y
// and the section output blends the lanes with the crossfade weight of
// ops/biquad.py:365-371, w = clip((total - remaining + 1 + t) / total, 0, 1)
// (w = 1 when total == 0), t the sample's index in the block. A section whose
// fade is idle at block start (remaining == 0) has identical lanes by
// construction: its output is lane 0's, and lane 0's state is stored for
// both. Promotion at block end stays in the wrapper.
//
// Layouts (stream-major): x, y [N, T] f32; coeffs [N, S, 2, 5] f32
// (b0 b1 b2 a1 a2 per crossfade lane); z [N, S, 2, 2] f64; fade_total and
// fade_remaining [N, S] int32.
//
// Design. A block owns G streams; each stream gets P lanes (P the power of
// two >= S, one warp-aligned group). Section s of the stream lives in lane s:
// its 10 coefficients are converted to f64 once and stay in registers with
// its 4 f64 state values. The block stages its streams' rows of x in shared
// memory (afk_tile_load, a coalesced cp.async copy, chunked over T where the
// tile would not fit). At step k, lane s filters the chunk's sample
// t = k - s: lane 0 reads x[t] from the tile (a float4 every 4 steps), lane
// s > 0 takes section s-1's output of the step before by __shfl_up_sync, and
// the last section writes y[t] over x[t] in the tile, which is then copied
// back to y. A chunk of tc samples takes tc + S - 1 steps. The step is
// branch-free (selects commit a lane's result only where its sample lies in
// the chunk); a warp with a crossfade in flight runs both crossfade lanes of
// every section and computes the weights of 4 steps together ahead of them
// (afk_quotient: a multiply and two FMAs in place of an f64 division, which
// cost 2.3x the crossfade's time), a warp without one (the steady state)
// runs lane 0 alone. Only the shuffle and the DFMA chain lie between one step and the
// next.
//
// Bound: the recurrence, not bytes or operations. Each step is one f64
// shuffle plus a dependent DFMA chain, and a block of T samples needs
// T + S - 1 such steps whatever the card's rates.
#include "afk.cuh"

constexpr int AFK_BIQUAD_MAX_SECTIONS = 16;
constexpr int BQ_GROUP = 4;  // steps per group (one float4 of x)

// Streams per thread block for P lanes per stream: 128 threads from P = 4 up,
// one or two warps of 32 streams below.
AFK_HD constexpr int bq_streams_per_block(int P) { return P >= 4 ? 128 / P : 32; }

// One section of one stream: both crossfade lanes' coefficients in f64 and
// their (z1, z2) state.
struct BiquadLane {
    double c[2][5];
    double z[2][2];
    double done;   // total - remaining + 1
    double total;
    double span;   // max(total, 1)
    double rcp;    // 1 / span, rounded
    bool fading;
};

// c: the section's [2, 5] f32 coefficients; z: its [2, 2] f64 state.
AFK_HD void bq_lane_load(BiquadLane& L, const float* c, const double* z,
                         int fade_total, int fade_remaining) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
#pragma unroll
        for (int i = 0; i < 5; ++i) L.c[l][i] = (double)c[l * 5 + i];
        L.z[l][0] = z[l * 2 + 0];
        L.z[l][1] = z[l * 2 + 1];
    }
    L.fading = fade_remaining > 0;
    L.total = (double)fade_total;
    L.done = (double)(fade_total - fade_remaining) + 1.0;
    L.span = fmax(L.total, 1.0);
    L.rcp = 1.0 / L.span;
}

// The crossfade weights of section lane s for the steps k0 .. k0+3 of a
// chunk that starts at block index c0 (step k filters sample c0 + k - s).
// An idle section never blends; its weights are left at 1.
AFK_HD void bq_group_weights(const BiquadLane& L, int k0, int s, int c0,
                             double w[BQ_GROUP]) {
#pragma unroll
    for (int j = 0; j < BQ_GROUP; ++j) w[j] = 1.0;
    if (!L.fading || !(L.total > 0.0)) return;
    const double n0 = L.done + (double)(c0 + k0 - s);
#pragma unroll
    for (int j = 0; j < BQ_GROUP; ++j)
        w[j] = fmin(fmax(afk_quotient(n0 + (double)j, L.span, L.rcp), 0.0), 1.0);
}

// Step k of a chunk's wavefront for section lane s (`on`: the lane holds a
// section of a stream) of a chunk of tc samples: filter the chunk's sample
// t = k - s with crossfade weight w and commit the result if t lies in
// [0, tc); `in` is x[t] for s == 0, else section s-1's output of step k-1.
// The last section writes its output over row[t]. FADE false leaves out the
// pending lane, for lanes none of which has a crossfade in flight; CHECK
// false drops the range check, for steps where every lane's sample lies in
// the chunk (bq_group_steady) and lanes without a section may commit.
template <bool FADE, bool CHECK>
AFK_HD void bq_wave_step(BiquadLane& L, double& v, double in, double w, int k, int s,
                         int S, bool on, int tc, float* row) {
    const int t = k - s;
    const bool valid = !CHECK || (on && t >= 0 && t < tc);
    const double* c0 = L.c[0];
    const double y0 = c0[0] * in + L.z[0][0];
    const double z00 = c0[1] * in - c0[3] * y0 + L.z[0][1];
    const double z01 = c0[2] * in - c0[4] * y0;
    double out = y0;
    if (FADE) {
        const double* c1 = L.c[1];
        const double y1 = c1[0] * in + L.z[1][0];
        const double z10 = c1[1] * in - c1[3] * y1 + L.z[1][1];
        const double z11 = c1[2] * in - c1[4] * y1;
        out = L.fading ? (1.0 - w) * y0 + w * y1 : y0;
        L.z[1][0] = valid ? z10 : L.z[1][0];
        L.z[1][1] = valid ? z11 : L.z[1][1];
    }
    L.z[0][0] = valid ? z00 : L.z[0][0];
    L.z[0][1] = valid ? z01 : L.z[0][1];
    v = valid ? out : v;
    if (valid && s == S - 1) row[t] = (float)out;
}

// Whether every lane's sample of steps k0 .. k0+3 lies in the chunk of tc
// samples: lane S-1 has started (k0 >= S - 1) and lane 0 has not ended.
AFK_HD bool bq_group_steady(int k0, int S, int tc) {
    return k0 >= S - 1 && k0 + BQ_GROUP <= tc;
}

// z_out: the section's [2, 2] f64 state; an idle section's lane 1 is lane 0.
AFK_HD void bq_lane_store(const BiquadLane& L, double* z_out) {
    z_out[0] = L.z[0][0];
    z_out[1] = L.z[0][1];
    z_out[2] = L.fading ? L.z[1][0] : L.z[0][0];
    z_out[3] = L.fading ? L.z[1][1] : L.z[0][1];
}

#ifdef __CUDACC__
// Steps k0 .. k0+3 of the wavefront for lane s of a group of P lanes.
template <int P, bool FADE, bool CHECK>
__device__ __forceinline__ void bq_group(BiquadLane& L, double& v, const float* xs,
                                         const double* w, int k0, int s, int S,
                                         bool active, int tc, float* row) {
#pragma unroll
    for (int j = 0; j < BQ_GROUP; ++j) {
        double in = (double)xs[j];
        if constexpr (P > 1) {
            const double up = __shfl_up_sync(0xffffffffu, v, 1, P);
            in = s > 0 ? up : in;
        }
        bq_wave_step<FADE, CHECK>(L, v, in, w[j], k0 + j, s, S, active, tc, row);
    }
}

// The wavefront over one staged chunk for lane s of a group of P lanes.
template <int P, bool FADE>
__device__ __forceinline__ void bq_chunk(BiquadLane& L, float* row, int s, int S,
                                         bool active, int c0, int tc) {
    double v = 0.0;
    // x[kb .. kb+3], read a group ahead; every lane reads (lane 0 uses it),
    // and reads past tc stay inside the padded row
    float4 cur = *reinterpret_cast<const float4*>(row);
    for (int kb = 0; kb < tc + S - 1; kb += BQ_GROUP) {
        const float4 nxt =
            *reinterpret_cast<const float4*>(row + afk_imin(kb + BQ_GROUP, (tc - 1) & ~3));
        const float xs[BQ_GROUP] = {cur.x, cur.y, cur.z, cur.w};
        double w[BQ_GROUP] = {1.0, 1.0, 1.0, 1.0};
        if (FADE) bq_group_weights(L, kb, s, c0, w);
        if (bq_group_steady(kb, S, tc))
            bq_group<P, FADE, false>(L, v, xs, w, kb, s, S, active, tc, row);
        else
            bq_group<P, FADE, true>(L, v, xs, w, kb, s, S, active, tc, row);
        cur = nxt;
    }
}

template <int P>
__global__ void biquad_cascade_kernel(const float* __restrict__ x,
                                      const float* __restrict__ coeffs,
                                      const double* __restrict__ z_in,
                                      const int* __restrict__ fade_total,
                                      const int* __restrict__ fade_remaining,
                                      float* __restrict__ y, double* __restrict__ z_out,
                                      int N, int S, int T, int tc_max, int stride) {
    constexpr int G = bq_streams_per_block(P);
    extern __shared__ __align__(16) float tile[];  // [G][stride]
    const int g = threadIdx.x / P, s = threadIdx.x % P;
    const int n0 = blockIdx.x * G;
    const int rows = afk_imin(G, N - n0);
    const bool active = g < rows && s < S;
    const long long sec = (long long)(n0 + g) * S + s;
    BiquadLane L = {};
    if (active)
        bq_lane_load(L, coeffs + sec * 10, z_in + sec * 4, fade_total[sec],
                     fade_remaining[sec]);
    // a warp none of whose sections fades (the steady state) runs lane 0 only
    const bool fade = __any_sync(0xffffffffu, active && L.fading);
    float* row = tile + g * stride;
    for (int c0 = 0; c0 < T; c0 += tc_max) {
        const int tc = afk_imin(tc_max, T - c0);
        afk_tile_load(tile, stride, x + (long long)n0 * T, rows, T, c0, tc);
        if (fade)
            bq_chunk<P, true>(L, row, s, S, active, c0, tc);
        else
            bq_chunk<P, false>(L, row, s, S, active, c0, tc);
        afk_tile_store(tile, stride, y + (long long)n0 * T, rows, T, c0, tc);
    }
    if (active) bq_lane_store(L, z_out + sec * 4);
}

template <int P>
static int launch_biquad_cascade(const float* x, const float* coeffs,
                                 const double* z_in, const int* fade_total,
                                 const int* fade_remaining, float* y,
                                 double* z_out, int N, int S, int T,
                                 cudaStream_t stream) {
    constexpr int G = bq_streams_per_block(P);
    if (N <= 0) return 0;
    const int tc_max = afk_tile_chunk(T, G, AFK_TILE_SMEM_BYTES);
    const int stride = afk_tile_stride(tc_max);
    const size_t smem = sizeof(float) * G * stride;
    static size_t allowed = 0;
    const int err = afk_allow_smem(biquad_cascade_kernel<P>, smem, allowed);
    if (err != 0) return err;
    biquad_cascade_kernel<P><<<(N + G - 1) / G, G * P, smem, stream>>>(
        x, coeffs, z_in, fade_total, fade_remaining, y, z_out, N, S, T, tc_max,
        stride);
    return static_cast<int>(cudaGetLastError());
}

AFK_API int afk_biquad_cascade(const float* x, const float* coeffs,
                               const double* z_in, const int* fade_total,
                               const int* fade_remaining, float* y,
                               double* z_out, int N, int S, int T,
                               void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (S < 1 || S > AFK_BIQUAD_MAX_SECTIONS || T < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int P = S <= 2 ? S : S <= 4 ? 4 : S <= 8 ? 8 : 16;
#define AFK_CASE(p)                                                          \
    case p:                                                                  \
        return launch_biquad_cascade<p>(x, coeffs, z_in, fade_total,         \
                                        fade_remaining, y, z_out, N, S, T, st);
    switch (P) {
        AFK_CASE(1) AFK_CASE(2) AFK_CASE(4) AFK_CASE(8) AFK_CASE(16)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef AFK_CASE
}
#endif

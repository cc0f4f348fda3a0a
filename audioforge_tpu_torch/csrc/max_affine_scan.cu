// max_affine_scan: u_t = max(v_t, rho * u_{t-1} + c_t) over a shared-memory
// tile of the block, and limiter_gain_scan: the same recurrence with the
// limiters' feed-forward math around it as parallel phases of one kernel.
//
// Replaces the TPU path's blocked associative max-affine scan
// (audioforge_tpu/ops/scan.py:305), which XLA compiled for the lookahead
// limiter (ops/limiter.py:131) and the true-peak limiter
// (ops/true_peak.py:191), and in the limiter form the elementwise lines
// around it there: the target gain over the decision peak (limiter.py:122-128,
// true_peak.py:181-188), the gain, the delayed input times the gain with the
// hard clamp (limiter.py:134-139, true_peak.py:194-197), the block's minimum
// gain and the limited-events flag (true_peak.py:203-207).
//
// Layouts (stream-major): v, c, u [N, T] f32; rho, u0 [N] f32. Limiter form:
// peak (the decision peak) and xd (the delayed input) [N, T] f32 with a row
// pitch of their own (both are windows of history-extended blocks); ceiling,
// rc (release coefficient), gain0 (the gain at the end of the block before)
// [N] f32; y [N, T] f32; gain_last, min_gain [N] f32; events [N] int32.
//
// Design. A block owns MA_STREAMS streams and stages their rows in shared
// memory (afk_tile_copy, coalesced cp.async; chunked over T where the rows
// would not fit, the recurrence's value carried in shared memory). The
// recurrence runs on one lane a stream through afk_serial_loop, which reads
// the next four samples' v and c while four step, and writes u over v. The
// sequential order is kept, so u is the plain twin's to the bit (built with
// -fmad=false, kernels/__init__.py: a contracted FMA would move u by an ulp,
// and the limiter form compares the target with the gain of the sample
// before). The limiter form gives each stream a warp for its parallel
// phases:
//   1  all samples: target = peak > ceiling ? clip(ceiling * scale / peak,
//      0, 1) : 1 (scale 1 for the lookahead limiter, 0.999 for the true-peak
//      limiter), v = 1 - target, c = (1 - rc) v;
//   2  serial: the recurrence;
//   3  all samples: gain = 1 - u, y = clamp(xd * gain, -ceiling, ceiling),
//      and per stream, reduced over the warp, the minimum gain and whether
//      any target lay below the gain of the sample before.
//
// Bound: the serial phase (T steps of a multiply, an add and a max); the
// bytes (8 or 12 in, 4 out per sample) take far less.
//
// Unlike jnp.maximum, fmaxf drops a NaN operand; the callers pass finite
// values (the limiters scrub their input first).
#include "afk.cuh"

constexpr int MA_STREAMS = 8;    // streams per block: 128 blocks for a fleet of 1024
constexpr int MA_THREADS = 256;  // a warp per stream in the parallel phases
static_assert(MA_THREADS == 32 * MA_STREAMS, "the limiter form maps a warp to a stream");
// shared memory per stream and row: chunks of up to 484 samples
constexpr int MA_ROW_BYTES = 2048;

// Rows of the shared tile, each MA_STREAMS rows of `stride` words (row r of
// stream g at (r * MA_STREAMS + g) * stride).
enum { MR_V = 0 /* v, then u */, MR_C = 1, MR_ROWS = 2 };
enum {
    LR_TARGET = 0,  // the decision peak, then the target gain
    LR_V = 1,       // v, then u
    LR_C = 2,
    LR_X = 3,       // the delayed input, then y
    LR_ROWS = 4
};

AFK_HD float* ma_row(float* tile, int stride, int r, int g) {
    return tile + (r * MA_STREAMS + g) * stride;
}

// Longest chunk of a T-sample block for a tile of `rows` rows per stream.
AFK_HD int ma_chunk(int T, int rows) {
    return afk_imax(afk_tile_chunk(T, rows * MA_STREAMS, rows * MA_STREAMS * MA_ROW_BYTES), 4);
}

// v = {v_t, c_t}
struct MaxAffineStep {
    float rho, s;
    float* u;
    AFK_HD void operator()(int t, const float (&v)[2]) {
        s = fmaxf(v[0], rho * s + v[1]);
        u[t] = s;
    }
};

// Serial, stream g: the recurrence over a chunk from `s`, u written over
// row `vrow`; returns u at the chunk's end.
AFK_HD float ma_phase_scan(float* tile, int stride, int vrow, int crow, int g, int tc,
                           float rho, float s) {
    float* v = ma_row(tile, stride, vrow, g);
    const float* const in[2] = {v, ma_row(tile, stride, crow, g)};
    MaxAffineStep step{rho, s, v};
    afk_serial_loop(in, tc, step);
    return step.s;
}

// Limiter form, phase 1 for sample t of stream g: the target gain over the
// decision peak, v and c.
AFK_HD void lg_sample_target(float* tile, int stride, int g, int t, float ceiling,
                             float scale, float rc) {
    float* target_row = ma_row(tile, stride, LR_TARGET, g);
    const float peak = target_row[t];
    const float target =
        peak > ceiling ? afk_clip(ceiling * scale / fmaxf(peak, 1e-30f), 0.0f, 1.0f) : 1.0f;
    const float v = 1.0f - target;
    target_row[t] = target;
    ma_row(tile, stride, LR_V, g)[t] = v;
    ma_row(tile, stride, LR_C, g)[t] = (1.0f - rc) * v;
}

// Limiter form, phase 3 for sample t of stream g: the gain (returned), the
// output over the x row, and whether the target lay below the gain of the
// sample before (`gain_before` for the chunk's first sample).
AFK_HD float lg_sample_output(float* tile, int stride, int g, int t, float ceiling,
                              float gain_before, bool& event) {
    const float* u = ma_row(tile, stride, LR_V, g);
    const float gain = 1.0f - u[t];
    const float prev = t > 0 ? 1.0f - u[t - 1] : gain_before;
    event = ma_row(tile, stride, LR_TARGET, g)[t] < prev;
    float* x = ma_row(tile, stride, LR_X, g);
    x[t] = afk_clip(x[t] * gain, -ceiling, ceiling);
    return gain;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(MA_THREADS)
max_affine_scan_kernel(const float* __restrict__ v, const float* __restrict__ c,
                       const float* __restrict__ rho, const float* __restrict__ u0,
                       float* __restrict__ u, int N, int T, int tc_max, int stride) {
    extern __shared__ __align__(16) float tile[];  // [MR_ROWS][MA_STREAMS][stride]
    __shared__ float carry[MA_STREAMS];
    const int n0 = blockIdx.x * MA_STREAMS;
    const int rows = afk_imin(MA_STREAMS, N - n0);
    const bool serial = threadIdx.x < rows;  // thread g runs stream g's recurrence
    if (serial) carry[threadIdx.x] = u0[n0 + threadIdx.x];
    for (int c0 = 0; c0 < T; c0 += tc_max) {
        const int tc = afk_imin(tc_max, T - c0);
        afk_tile_copy(ma_row(tile, stride, MR_V, 0), stride, v + (long long)n0 * T, rows, T, c0, tc);
        afk_tile_copy(ma_row(tile, stride, MR_C, 0), stride, c + (long long)n0 * T, rows, T, c0, tc);
        afk_tile_wait();
        if (serial)
            carry[threadIdx.x] = ma_phase_scan(tile, stride, MR_V, MR_C, threadIdx.x, tc,
                                               rho[n0 + threadIdx.x], carry[threadIdx.x]);
        afk_tile_store(ma_row(tile, stride, MR_V, 0), stride, u + (long long)n0 * T, rows, T, c0,
                       tc);
    }
}

__global__ void __launch_bounds__(MA_THREADS)
limiter_gain_scan_kernel(const float* __restrict__ peak, int peak_ld,
                         const float* __restrict__ xd, int xd_ld,
                         const float* __restrict__ ceiling, const float* __restrict__ rc,
                         const float* __restrict__ gain0, float scale, float* __restrict__ y,
                         float* __restrict__ gain_last, float* __restrict__ min_gain,
                         int* __restrict__ events, int N, int T, int tc_max, int stride) {
    extern __shared__ __align__(16) float tile[];  // [LR_ROWS][MA_STREAMS][stride]
    __shared__ float carry[MA_STREAMS];            // u at the end of the chunk before
    const int n0 = blockIdx.x * MA_STREAMS;
    const int rows = afk_imin(MA_STREAMS, N - n0);
    const bool serial = threadIdx.x < rows;
    // the parallel phases: warp g takes stream g
    const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool on = g < rows;
    const float ceil_g = on ? ceiling[n0 + g] : 0.0f;
    const float rc_g = on ? rc[n0 + g] : 0.0f;
    float gain_before = on ? gain0[n0 + g] : 1.0f;
    float least = INFINITY;  // of the block's gains
    bool any_event = false;
    if (serial) carry[threadIdx.x] = 1.0f - gain0[n0 + threadIdx.x];
    for (int c0 = 0; c0 < T; c0 += tc_max) {
        const int tc = afk_imin(tc_max, T - c0);
        afk_tile_copy(ma_row(tile, stride, LR_TARGET, 0), stride, peak + (long long)n0 * peak_ld,
                      rows, peak_ld, c0, tc);
        afk_tile_copy(ma_row(tile, stride, LR_X, 0), stride, xd + (long long)n0 * xd_ld, rows,
                      xd_ld, c0, tc);
        afk_tile_wait();
        if (on)  // 1
            for (int t = lane; t < tc; t += 32)
                lg_sample_target(tile, stride, g, t, ceil_g, scale, rc_g);
        __syncthreads();
        if (serial)  // 2
            carry[threadIdx.x] = ma_phase_scan(tile, stride, LR_V, LR_C, threadIdx.x, tc,
                                               rc[n0 + threadIdx.x], carry[threadIdx.x]);
        __syncthreads();
        if (on) {  // 3
            for (int t = lane; t < tc; t += 32) {
                bool event;
                const float gain = lg_sample_output(tile, stride, g, t, ceil_g, gain_before, event);
                least = fminf(least, gain);
                any_event |= event;
            }
            gain_before = 1.0f - carry[g];
        }
        afk_tile_store(ma_row(tile, stride, LR_X, 0), stride, y + (long long)n0 * T, rows, T, c0,
                       tc);
    }
    int fired = any_event;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        least = fminf(least, __shfl_xor_sync(0xffffffffu, least, o));
        fired |= __shfl_xor_sync(0xffffffffu, fired, o);
    }
    if (on && lane == 0) {
        min_gain[n0 + g] = least;
        events[n0 + g] = fired;
        gain_last[n0 + g] = gain_before;
    }
}

AFK_API int afk_max_affine_scan(const float* v, const float* c,
                                const float* rho, const float* u0, float* u,
                                int N, int T, void* stream) {
    if (T < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (N <= 0) return 0;
    const int tc_max = ma_chunk(T, MR_ROWS);
    const int stride = afk_tile_stride(tc_max);
    const size_t smem = sizeof(float) * MR_ROWS * MA_STREAMS * stride;
    max_affine_scan_kernel<<<(N + MA_STREAMS - 1) / MA_STREAMS, MA_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(v, c, rho, u0, u, N, T,
                                                                  tc_max, stride);
    return static_cast<int>(cudaGetLastError());
}

AFK_API int afk_limiter_gain_scan(const float* peak, int peak_ld, const float* xd, int xd_ld,
                                  const float* ceiling, const float* rc, const float* gain0,
                                  float scale, float* y, float* gain_last, float* min_gain,
                                  int* events, int N, int T, void* stream) {
    if (T < 1 || peak_ld < T || xd_ld < T) return static_cast<int>(cudaErrorInvalidValue);
    if (N <= 0) return 0;
    const int tc_max = ma_chunk(T, LR_ROWS);
    const int stride = afk_tile_stride(tc_max);
    const size_t smem = sizeof(float) * LR_ROWS * MA_STREAMS * stride;
    static size_t allowed = 0;
    const int err = afk_allow_smem(limiter_gain_scan_kernel, smem, allowed);
    if (err != 0) return err;
    limiter_gain_scan_kernel<<<(N + MA_STREAMS - 1) / MA_STREAMS, MA_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        peak, peak_ld, xd, xd_ld, ceiling, rc, gain0, scale, y, gain_last, min_gain, events, N, T,
        tc_max, stride);
    return static_cast<int>(cudaGetLastError());
}
#endif

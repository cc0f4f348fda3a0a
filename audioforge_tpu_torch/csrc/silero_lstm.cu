// vad_lstm_head: Silero's LSTM cell after its GEMMs, the decoder head and
// the serving step's smoothing and calibration, one pass per stream.
//
// Replaces what XLA compiled on the TPU for the back of the serving step's
// Silero call (no Pallas kernel): the pointwise LSTMCell(128, 128) of
// `models/silero.py silero_infer` (ifgo gate order; the two [N,128]x[128,512]
// GEMMs stay torch.matmul), ReLU, the 128 -> 1 head and the sigmoid, then
// `runtime/serving.py _vad_step`: clip, the warm-up and the 0.5 EMA from the
// first warm block on, Platt calibration (`calibrate_probability`). It writes
// h1 and c1 into the [N, 2, 128] state, the smoothed posterior, blocks seen +
// 1, the calibrated probability and whether it is available (warm).
//
// Bound: bytes, ~3.6 KB a stream (gate pre-activations 2 KB, c0 0.5 KB, the
// new h and c 1 KB), ~3.7 MB at fleet 1024. Design: one block of 128 threads
// a stream, so the grid is the streams and at one stream (the live engine's
// VAD window) no block waits for another stream. Thread u owns hidden unit u
// and issues every load before it uses any (coalesced words): its four gate
// pre-activations, the eight biases, c0 and the head weight, and thread 0 the
// stream's scalars (EMA, blocks seen, smoothing, head bias). Its h1 and c1 go
// out as soon as they are computed. The head's dot product is a warp
// butterfly on each of the four warps and the warps' parts added in warp
// order by thread 0, which then runs the scalar tail while the other warps'
// stores drain. Timed on the card with compare_kernels.py (PERF.md): one warp
// a stream with four units a lane, and two or four streams a block, were no
// faster. Built with -fmad=false: the probability meets the gate's
// thresholds, so it rounds as the plain twin's elementwise ops do.
#include "afk.cuh"

constexpr int VL_HIDDEN = 128;                // threads a stream: one a hidden unit
constexpr int VL_WARPS = VL_HIDDEN / 32;       // parts of the head's dot product
constexpr float VL_CAL_A = 0.6922877f;  // Platt calibration (silero.py)
constexpr float VL_CAL_B = 0.08612386f;

AFK_HD float vl_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

AFK_HD bool vl_finite(float v) { return v - v == 0.0f; }

// jnp.clip(v, lo, hi), NaN passing through as it does there
AFK_HD float vl_clip(float v, float lo, float hi) {
    return v != v ? v : afk_clip(v, lo, hi);
}

// One hidden unit: gate pre-activations (the GEMMs' sum, biases added here
// in the reference's order), c0 -> h1, c1. Returns relu(h1) * head weight.
AFK_HD float vl_unit(float gi, float gf, float gg, float go, float bii, float bif,
                     float big, float bio, float bhi, float bhf, float bhg, float bho,
                     float c0, float hw, float* h1, float* c1) {
    const float i = vl_sigmoid(gi + bii + bhi);
    const float f = vl_sigmoid(gf + bif + bhf);
    const float g = tanhf(gg + big + bhg);
    const float o = vl_sigmoid(go + bio + bho);
    const float c = f * c0 + i * g;
    const float h = o * tanhf(c);
    *c1 = c;
    *h1 = h;
    return fmaxf(h, 0.0f) * hw;
}

// serving.calibrate_probability
AFK_HD float vl_calibrate(float p) {
    if (!vl_finite(p)) return 0.0f;
    const float b = afk_clip(p, 1e-6f, 0.999999f);
    const float logit = logf(b / (1.0f - b));
    const float t = afk_clip(VL_CAL_A * logit + VL_CAL_B, -30.0f, 30.0f);
    return afk_clip(1.0f / (1.0f + expf(-t)), 0.0f, 1.0f);
}

// The stream's tail from the head's dot product: the posterior, the EMA
// (0 until warm, the first warm block's posterior, then the EMA) and its
// calibration.
AFK_HD void vl_finish(float dot, float head_b, float smoothing, float smoothed_in,
                      int seen, int warmup_blocks, float* smoothed_out, int* seen_out,
                      float* prob_out, bool* avail_out) {
    const float prob = vl_clip(vl_sigmoid(dot + head_b), 0.0f, 1.0f);
    const bool warm = seen >= warmup_blocks - 1;
    const bool first = seen == warmup_blocks - 1;
    float sm = first ? prob : smoothing * prob + (1.0f - smoothing) * smoothed_in;
    sm = warm ? sm : 0.0f;
    *smoothed_out = sm;
    *seen_out = seen + 1;
    *prob_out = vl_calibrate(sm);
    *avail_out = warm;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(VL_HIDDEN)
vad_lstm_head_kernel(const float* __restrict__ gates, const float* __restrict__ lstm,
                     const float* __restrict__ bi, const float* __restrict__ bh,
                     const float* __restrict__ head_w, const float* __restrict__ head_b,
                     const float* __restrict__ smoothed, const int* __restrict__ seen,
                     const float* __restrict__ smoothing, float* __restrict__ lstm_out,
                     float* __restrict__ smoothed_out, int* __restrict__ seen_out,
                     float* __restrict__ prob, bool* __restrict__ avail, int warmup_blocks) {
    __shared__ float part[VL_WARPS];
    constexpr int H = VL_HIDDEN;
    const int u = threadIdx.x, lane = u & 31, w = u >> 5;
    const long long n = blockIdx.x;
    const float* g = gates + n * 4 * H;
    const float gi = g[u], gf = g[H + u], gg = g[2 * H + u], go = g[3 * H + u];
    const float bii = bi[u], bif = bi[H + u], big = bi[2 * H + u], bio = bi[3 * H + u];
    const float bhi = bh[u], bhf = bh[H + u], bhg = bh[2 * H + u], bho = bh[3 * H + u];
    const float c0 = lstm[n * 2 * H + H + u], hw = head_w[u];
    float sm_in = 0.0f, smooth = 0.0f, hb = 0.0f;
    int seen_in = 0;
    if (u == 0) {
        sm_in = smoothed[n];
        seen_in = seen[n];
        smooth = *smoothing;
        hb = *head_b;
    }
    float* so = lstm_out + n * 2 * H;
    float acc = vl_unit(gi, gf, gg, go, bii, bif, big, bio, bhi, bhf, bhg, bho, c0, hw, so + u,
                        so + H + u);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) part[w] = acc;
    __syncthreads();
    if (u != 0) return;
#pragma unroll
    for (int q = 1; q < VL_WARPS; ++q) acc += part[q];
    vl_finish(acc, hb, smooth, sm_in, seen_in, warmup_blocks, smoothed_out + n, seen_out + n,
              prob + n, avail + n);
}

AFK_API int afk_vad_lstm_head(const float* gates, const float* lstm, const float* bi,
                              const float* bh, const float* head_w, const float* head_b,
                              const float* smoothed, const int* seen,
                              const float* smoothing, float* lstm_out,
                              float* smoothed_out, int* seen_out, float* prob,
                              bool* avail, int N, int warmup_blocks, void* stream) {
    vad_lstm_head_kernel<<<N, VL_HIDDEN, 0, static_cast<cudaStream_t>(stream)>>>(
        gates, lstm, bi, bh, head_w, head_b, smoothed, seen, smoothing, lstm_out,
        smoothed_out, seen_out, prob, avail, warmup_blocks);
    return static_cast<int>(cudaGetLastError());
}
#endif

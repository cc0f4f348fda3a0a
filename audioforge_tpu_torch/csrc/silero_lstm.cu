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
// new h and c 1 KB), ~3.7 MB at fleet 1024. Design: one warp a stream, four
// hidden units a lane read as float4 (coalesced), the head's dot product a
// warp butterfly, lane 0 the stream's scalar tail. Built with -fmad=false:
// the probability meets the gate's thresholds, so it rounds as the plain
// twin's elementwise ops do.
#include "afk.cuh"

constexpr int VL_HIDDEN = 128;
constexpr int VL_UNITS = 4;           // hidden units a lane
constexpr int VL_WARPS = 8;           // streams a thread block
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
__global__ void __launch_bounds__(VL_WARPS * 32)
vad_lstm_head_kernel(const float* __restrict__ gates, const float* __restrict__ lstm,
                     const float* __restrict__ bi, const float* __restrict__ bh,
                     const float* __restrict__ head_w, const float* __restrict__ head_b,
                     const float* __restrict__ smoothed, const int* __restrict__ seen,
                     const float* __restrict__ smoothing, float* __restrict__ lstm_out,
                     float* __restrict__ smoothed_out, int* __restrict__ seen_out,
                     float* __restrict__ prob, bool* __restrict__ avail, int N,
                     int warmup_blocks) {
    const int lane = threadIdx.x & 31;
    const int n = blockIdx.x * VL_WARPS + (threadIdx.x >> 5);
    if (n >= N) return;
    const int u = VL_UNITS * lane;
    const float* g = gates + (long long)n * 4 * VL_HIDDEN;
    const float4 gi = *reinterpret_cast<const float4*>(g + u);
    const float4 gf = *reinterpret_cast<const float4*>(g + VL_HIDDEN + u);
    const float4 gg = *reinterpret_cast<const float4*>(g + 2 * VL_HIDDEN + u);
    const float4 go = *reinterpret_cast<const float4*>(g + 3 * VL_HIDDEN + u);
    const float4 bii = *reinterpret_cast<const float4*>(bi + u);
    const float4 bif = *reinterpret_cast<const float4*>(bi + VL_HIDDEN + u);
    const float4 big = *reinterpret_cast<const float4*>(bi + 2 * VL_HIDDEN + u);
    const float4 bio = *reinterpret_cast<const float4*>(bi + 3 * VL_HIDDEN + u);
    const float4 bhi = *reinterpret_cast<const float4*>(bh + u);
    const float4 bhf = *reinterpret_cast<const float4*>(bh + VL_HIDDEN + u);
    const float4 bhg = *reinterpret_cast<const float4*>(bh + 2 * VL_HIDDEN + u);
    const float4 bho = *reinterpret_cast<const float4*>(bh + 3 * VL_HIDDEN + u);
    const float* st = lstm + (long long)n * 2 * VL_HIDDEN;
    const float4 c0 = *reinterpret_cast<const float4*>(st + VL_HIDDEN + u);
    const float4 hw = *reinterpret_cast<const float4*>(head_w + u);
    float4 h1, c1;
    float part = vl_unit(gi.x, gf.x, gg.x, go.x, bii.x, bif.x, big.x, bio.x, bhi.x, bhf.x,
                         bhg.x, bho.x, c0.x, hw.x, &h1.x, &c1.x);
    part += vl_unit(gi.y, gf.y, gg.y, go.y, bii.y, bif.y, big.y, bio.y, bhi.y, bhf.y, bhg.y,
                    bho.y, c0.y, hw.y, &h1.y, &c1.y);
    part += vl_unit(gi.z, gf.z, gg.z, go.z, bii.z, bif.z, big.z, bio.z, bhi.z, bhf.z, bhg.z,
                    bho.z, c0.z, hw.z, &h1.z, &c1.z);
    part += vl_unit(gi.w, gf.w, gg.w, go.w, bii.w, bif.w, big.w, bio.w, bhi.w, bhf.w, bhg.w,
                    bho.w, c0.w, hw.w, &h1.w, &c1.w);
    float* so = lstm_out + (long long)n * 2 * VL_HIDDEN;
    *reinterpret_cast<float4*>(so + u) = h1;
    *reinterpret_cast<float4*>(so + VL_HIDDEN + u) = c1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0)
        vl_finish(part, *head_b, *smoothing, smoothed[n], seen[n], warmup_blocks,
                  smoothed_out + n, seen_out + n, prob + n, avail + n);
}

AFK_API int afk_vad_lstm_head(const float* gates, const float* lstm, const float* bi,
                              const float* bh, const float* head_w, const float* head_b,
                              const float* smoothed, const int* seen,
                              const float* smoothing, float* lstm_out,
                              float* smoothed_out, int* seen_out, float* prob,
                              bool* avail, int N, int warmup_blocks, void* stream) {
    const int blocks = (N + VL_WARPS - 1) / VL_WARPS;
    vad_lstm_head_kernel<<<blocks, VL_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        gates, lstm, bi, bh, head_w, head_b, smoothed, seen, smoothing, lstm_out,
        smoothed_out, seen_out, prob, avail, N, warmup_blocks);
    return static_cast<int>(cudaGetLastError());
}
#endif

// vad_front: the in-step VAD's feed-forward front end, one pass per stream.
//
// Replaces what XLA compiled on the TPU for the front of the serving step's
// Silero call (no Pallas kernel): `ops/resample.py decimate3` (a 31-tap
// windowed-sinc low-pass at stride 3 over the 30-sample history plus the
// block, [N, 480] -> [N, 160]), the roll of the 576-sample 16 kHz window by
// 160 (`runtime/serving.py _vad_step`), the pre-gain, and the right reflect
// pad and four 256-sample frames at hop 128 of `models/silero.py _stft_mag`.
// Per stream it writes the new history [30], the new (unscaled) window [576]
// and the frames [4, 256] as rows of one contiguous [N * 4, 256] operand,
// which torch.matmul then projects onto the [256, 258] Fourier basis. The
// basis (258 x 256 x 4 = 264 KB) does not fit a block's 227 KB of shared
// memory, so the projection stays a GEMM.
//
// Bound: bytes, 10,224 B a stream (the block, the history and the kept 416
// samples of the window read once; history, window and frames written once),
// 10.5 MB at fleet 1024.
//
// Design: one block of 160 threads a stream (1,024 blocks of five warps at
// fleet 1024), so an SM holds several streams' blocks at once and one
// block's loads overlap another's stores; the grid is the streams, so no
// block waits for another stream. Every thread issues its loads before it
// uses any: at most one 16-byte piece of the block, one of the kept window
// (which goes straight on to window_out from the register) and one 8-byte
// piece of the history. Thread o computes decimated sample o (the taps in
// __constant__ memory, a warp-uniform read that broadcasts; the ext row at
// stride 3 words, no bank conflict), so no divide or modulo per element.
// Then every store is 16 bytes: the window's 40 new quads and the frames'
// 256 quads, each frame quad one aligned shared read times the pre-gain
// (one read a thread, before the loads), but for frame 3's last 16 quads,
// which the reflect index builds from four words. Timed on the card with
// compare_kernels.py (PERF.md), two streams a block, 128 threads, cp.async
// loads and 4-byte stores were no faster.
#include "afk.cuh"

constexpr int VF_BLOCK = 480;   // 48 kHz samples in
constexpr int VF_TAPS = 31;
constexpr int VF_HIST = VF_TAPS - 1;
constexpr int VF_OUT = VF_BLOCK / 3;  // 160 16 kHz samples out
constexpr int VF_WIN = 576;           // Silero's input: 64 context + 512
constexpr int VF_KEEP = VF_WIN - VF_OUT;
constexpr int VF_FRAMES = 4, VF_FRAME = 256, VF_HOP = 128;
constexpr int VF_THREADS = VF_OUT;   // one a decimated sample
// ext (history then block) sits at offset VF_EXT0 of its row, so the block
// starts 16-byte aligned (VF_EXT0 + VF_HIST = 32) and the history 8-byte
constexpr int VF_EXT0 = 2;
constexpr int VF_EXT_LEN = VF_EXT0 + VF_HIST + VF_BLOCK;
constexpr int VF_QUADS = VF_FRAMES * VF_FRAME / 4;   // 256 frame quads a stream
constexpr int VF_NEW_QUADS = VF_OUT / 4;             // 40 quads of new window samples

// decimate3_taps() (ops/resample.py): the flipped 31-tap windowed sinc, f32
#define VF_TAP_VALUES                                                           \
    1.910036549e-19f, 3.092775005e-04f, 7.966037374e-04f, -9.326800551e-19f,   \
        -3.027657978e-03f, -5.140081979e-03f, 3.497063617e-18f,                \
        1.265783142e-02f, 1.880287565e-02f, -7.716087165e-18f,                 \
        -3.909470141e-02f, -5.617042258e-02f, 1.173919340e-17f,                \
        1.332777292e-01f, 2.757106721e-01f, 3.333892226e-01f,                  \
        2.665554583e-01f, 1.245229170e-01f, 1.059074824e-17f,                  \
        -4.886838049e-02f, -3.273920715e-02f, -6.204135422e-18f,               \
        1.446609385e-02f, 9.273733012e-03f, 2.422863713e-18f,                  \
        -3.330423729e-03f, -1.798792509e-03f, -4.881402692e-19f,               \
        3.330680775e-04f, 7.419549365e-05f, -7.065438284e-34f

static const float vf_taps_host[VF_TAPS] = {VF_TAP_VALUES};
#ifdef __CUDACC__
__constant__ float vf_taps_dev[VF_TAPS] = {VF_TAP_VALUES};
#endif
#ifdef __CUDA_ARCH__
#define VF_TAP(t) vf_taps_dev[t]
#else
#define VF_TAP(t) vf_taps_host[t]
#endif

// Decimated sample o of ext = history (30) then block (480).
AFK_HD float vf_decimate(const float* ext, int o) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < VF_TAPS; ++t) acc += ext[3 * o + t] * VF_TAP(t);
    return acc;
}

// Index into the window of sample i of the right-reflect-padded window
// (x[:, -2:-2-64:-1]: the edge sample is not repeated).
AFK_HD int vf_pad_index(int i) { return i < VF_WIN ? i : 2 * VF_WIN - 2 - i; }

// Quad q (elements 4q .. 4q+3) of the stream's frames [4, 256] from the new
// window, times the pre-gain. A quad lies wholly inside the window (one
// aligned 16-byte read) or wholly in the reflected pad (frame 3, q >= 240).
AFK_HD float4 vf_frame_quad(const float* win, int q, float gain) {
    const int i0 = (q / (VF_FRAME / 4)) * VF_HOP + 4 * (q % (VF_FRAME / 4));
    const float4 v = i0 < VF_WIN ? afk_load4(win + i0)
                                 : make_float4(win[vf_pad_index(i0)], win[vf_pad_index(i0 + 1)],
                                               win[vf_pad_index(i0 + 2)],
                                               win[vf_pad_index(i0 + 3)]);
    return make_float4(v.x * gain, v.y * gain, v.z * gain, v.w * gain);
}

AFK_API float afk_vad_front_tap(int t) { return vf_taps_host[t]; }

#ifdef __CUDACC__
__global__ void __launch_bounds__(VF_THREADS)
vad_front_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                 const float* __restrict__ window, const float* __restrict__ pre_gain,
                 float* __restrict__ hist_out, float* __restrict__ window_out,
                 float* __restrict__ frames) {
    __shared__ __align__(16) float ext[VF_EXT_LEN];
    __shared__ __align__(16) float win[VF_WIN];
    const int t = threadIdx.x;
    const long long n = blockIdx.x;
    float4* wo = reinterpret_cast<float4*>(window_out + n * VF_WIN);
    const float gain = *pre_gain;
    float4 xv, kv;
    float2 hv;
    if (t < VF_BLOCK / 4) xv = reinterpret_cast<const float4*>(x + n * VF_BLOCK)[t];
    if (t < VF_KEEP / 4) kv = reinterpret_cast<const float4*>(window + n * VF_WIN + VF_OUT)[t];
    if (t < VF_HIST / 2) hv = reinterpret_cast<const float2*>(hist + n * VF_HIST)[t];
    if (t < VF_BLOCK / 4) *reinterpret_cast<float4*>(ext + VF_EXT0 + VF_HIST + 4 * t) = xv;
    if (t < VF_KEEP / 4) {
        *reinterpret_cast<float4*>(win + 4 * t) = kv;
        wo[t] = kv;
    }
    if (t < VF_HIST / 2) *reinterpret_cast<float2*>(ext + VF_EXT0 + 2 * t) = hv;
    __syncthreads();
    win[VF_KEEP + t] = vf_decimate(ext + VF_EXT0, t);
    if (t < VF_HIST / 2)
        reinterpret_cast<float2*>(hist_out + n * VF_HIST)[t] =
            *reinterpret_cast<const float2*>(ext + VF_EXT0 + VF_BLOCK + 2 * t);
    __syncthreads();
    float4* fo = reinterpret_cast<float4*>(frames + n * VF_FRAMES * VF_FRAME);
    for (int i = t; i < VF_QUADS + VF_NEW_QUADS; i += VF_THREADS) {
        if (i < VF_QUADS)
            fo[i] = vf_frame_quad(win, i, gain);
        else
            wo[VF_KEEP / 4 + i - VF_QUADS] = afk_load4(win + VF_KEEP + 4 * (i - VF_QUADS));
    }
}

AFK_API int afk_vad_front(const float* x, const float* hist, const float* window,
                          const float* pre_gain, float* hist_out, float* window_out,
                          float* frames, int N, void* stream) {
    vad_front_kernel<<<N, VF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, hist, window, pre_gain, hist_out, window_out, frames);
    return static_cast<int>(cudaGetLastError());
}
#endif

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
// Bound: bytes, about 11 KB a stream (the block, the history and the kept
// window read once; history, window and frames written once), ~11 MB at
// fleet 1024. Design: 8 streams a block; the block's rows, histories and kept
// windows are staged in shared memory with afk_tile_copy; the taps live in
// __constant__ memory; every step is feed-forward, so all 256 threads take
// the decimation and then the window and frame writes, coalesced.
#include "afk.cuh"

constexpr int VF_BLOCK = 480;   // 48 kHz samples in
constexpr int VF_TAPS = 31;
constexpr int VF_HIST = VF_TAPS - 1;
constexpr int VF_OUT = VF_BLOCK / 3;  // 160 16 kHz samples out
constexpr int VF_WIN = 576;           // Silero's input: 64 context + 512
constexpr int VF_KEEP = VF_WIN - VF_OUT;
constexpr int VF_FRAMES = 4, VF_FRAME = 256, VF_HOP = 128;
constexpr int VF_STREAMS = 8;         // streams a thread block
constexpr int VF_THREADS = 256;
// ext (history then block) sits at offset VF_EXT0 of its tile row, so the
// block starts 16-byte aligned (VF_EXT0 + VF_HIST = 32)
constexpr int VF_EXT0 = 2;
constexpr int VF_EXT_STRIDE = 516;    // afk_tile_stride(512)
constexpr int VF_WIN_STRIDE = 580;    // afk_tile_stride(576)

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
    for (int t = 0; t < VF_TAPS; ++t) acc += ext[3 * o + t] * VF_TAP(t);
    return acc;
}

// Index into the window of sample i of the right-reflect-padded window
// (x[:, -2:-2-64:-1]: the edge sample is not repeated).
AFK_HD int vf_pad_index(int i) { return i < VF_WIN ? i : 2 * VF_WIN - 2 - i; }

// Element n of frame f, scaled by the pre-gain.
AFK_HD float vf_frame_value(const float* win, int f, int n, float gain) {
    return win[vf_pad_index(f * VF_HOP + n)] * gain;
}

AFK_API float afk_vad_front_tap(int t) { return vf_taps_host[t]; }

#ifdef __CUDACC__
__global__ void __launch_bounds__(VF_THREADS)
vad_front_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                 const float* __restrict__ window, const float* __restrict__ pre_gain,
                 float* __restrict__ hist_out, float* __restrict__ window_out,
                 float* __restrict__ frames, int N) {
    __shared__ __align__(16) float ext[VF_STREAMS * VF_EXT_STRIDE];
    __shared__ __align__(16) float win[VF_STREAMS * VF_WIN_STRIDE];
    const int s0 = blockIdx.x * VF_STREAMS;
    const int rows = afk_imin(VF_STREAMS, N - s0);
    afk_tile_copy(ext + VF_EXT0 + VF_HIST, VF_EXT_STRIDE, x + (long long)s0 * VF_BLOCK, rows,
                  VF_BLOCK, 0, VF_BLOCK);
    afk_tile_copy(ext + VF_EXT0, VF_EXT_STRIDE, hist + (long long)s0 * VF_HIST, rows, VF_HIST,
                  0, VF_HIST);
    afk_tile_copy(win, VF_WIN_STRIDE, window + (long long)s0 * VF_WIN, rows, VF_WIN, VF_OUT,
                  VF_KEEP);
    afk_tile_wait();
    for (int i = threadIdx.x; i < rows * VF_OUT; i += blockDim.x) {
        const int s = i / VF_OUT, o = i - s * VF_OUT;
        win[s * VF_WIN_STRIDE + VF_KEEP + o] = vf_decimate(ext + s * VF_EXT_STRIDE + VF_EXT0, o);
    }
    for (int i = threadIdx.x; i < rows * VF_HIST; i += blockDim.x) {
        const int s = i / VF_HIST, j = i - s * VF_HIST;
        hist_out[(long long)s0 * VF_HIST + i] =
            ext[s * VF_EXT_STRIDE + VF_EXT0 + VF_BLOCK + j];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * VF_WIN; i += blockDim.x) {
        const int s = i / VF_WIN, j = i - s * VF_WIN;
        window_out[(long long)s0 * VF_WIN + i] = win[s * VF_WIN_STRIDE + j];
    }
    const float gain = *pre_gain;
    constexpr int per_stream = VF_FRAMES * VF_FRAME;
    for (int i = threadIdx.x; i < rows * per_stream; i += blockDim.x) {
        const int s = i / per_stream, k = i - s * per_stream;
        frames[(long long)s0 * per_stream + i] =
            vf_frame_value(win + s * VF_WIN_STRIDE, k / VF_FRAME, k % VF_FRAME, gain);
    }
}

AFK_API int afk_vad_front(const float* x, const float* hist, const float* window,
                          const float* pre_gain, float* hist_out, float* window_out,
                          float* frames, int N, void* stream) {
    const int blocks = (N + VF_STREAMS - 1) / VF_STREAMS;
    vad_front_kernel<<<blocks, VF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, hist, window, pre_gain, hist_out, window_out, frames, N);
    return static_cast<int>(cudaGetLastError());
}
#endif

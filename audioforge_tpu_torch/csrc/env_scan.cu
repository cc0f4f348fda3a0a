// env_scan: one-pole attack/release envelope with a log post-op.
//
// Replaces the Pallas TPU kernel `env_kernel`
// (tools/evaluate_scan_kernel_strategy.py:72-87): per column b and sample t,
//   a = |x[t,b]|; c = a > env ? 0.3 : 0.01; env = c*env + (1-c)*a;
//   y[t,b] = log(max(env, 1e-10)).
// Layout is the tool's time-major [T, B] f32; the last env of every column
// is the second output.
//
// The choice between attack and release is the smaller of the two updates:
// with u = 0.3 env + 0.7 a and d = 0.01 env + 0.99 a, u - d = 0.29 (env - a),
// so a > env gives u < d and a <= env gives d <= u. Both are formed beside
// each other and one min picks; only where a and env agree to a few ulps can
// the rounded candidates order otherwise, and then they differ by as little.
//
// Bound: the serial chain of T dependent steps per column, not the bytes
// (8 B an element, 2.35 us at [480, 2048] over 3.35 TB/s). Design: a block
// owns a strip of ES_WIDTH columns (128 blocks at B = 2048, about one an
// SM) and stages it in chunks of ES_CHUNK samples in a ring of ES_STAGES
// shared-memory tiles. A tile is column-major, a column a row of ES_STRIDE
// words (4 mod 32: sixteen lanes' 16-byte reads at one sample take the two
// wavefronts they need), filled by 4-byte cp.async pieces of the strip's
// time-major rows (a row of 16 columns is 64 bytes, read coalesced). Warp 0
// runs only the recurrence, one lane a column: four samples a 16-byte shared
// read and the next four read while they step, env written back over x four
// at a time, so the chain per step is an FMA and a min (FFMA, FMNMX) and one
// shared access in four steps stands beside it. The other warps keep
// ES_AHEAD chunks of copies in flight (the whole [480, 16] strip from the
// start), tell the serial warp that chunk k + 1 has landed as soon as it
// starts chunk k, and a chunk behind it take log(max(env, 1e-10)) and store
// y as 16-byte rows. The two sides meet at named barriers in
// producer/consumer pairs (chunk k landed; chunk k's env written), so the
// serial warp waits for no log, store or copy; the last chunk's log runs on
// every warp.
#include "afk.cuh"

constexpr int ES_WIDTH = 16;                   // columns a block
constexpr int ES_CHUNK = 2048 / ES_WIDTH;      // samples a chunk: an 8 KB tile
constexpr int ES_STRIDE = ES_CHUNK + 4;        // words a tile column: 4 mod 32, room to read ahead
constexpr int ES_AHEAD = 4;                    // chunks in flight from the start
constexpr int ES_STAGES = ES_AHEAD + 1;        // tiles in the ring
constexpr int ES_THREADS = 128;                // warp 0 serial, the rest copy, log, store
constexpr int ES_TILE = ES_WIDTH * ES_STRIDE;
constexpr int ES_QUADS = ES_WIDTH / 4;         // 16-byte pieces of a strip row
constexpr int ES_BAR_FULL = 1;                 // + (k & 1): chunk k landed
constexpr int ES_BAR_DONE = 3;                 // + (k & 1): chunk k's env written
static_assert(ES_WIDTH <= 32 && ES_WIDTH % 4 == 0, "a strip is one warp's lanes");
static_assert(ES_STRIDE % 32 == 4, "tile columns skew the banks");
static_assert(ES_AHEAD >= 3, "chunk k + 1 is in flight before chunk k - 1 is logged");
static_assert((ES_THREADS - 32) % ES_WIDTH == 0, "the copying threads cover whole strip rows");

// One step of the recurrence from env; the attack and release terms are
// formed from |v| off the chain and the two candidates side by side, so the
// chain is an FMA and a min.
AFK_HD float env_scan_step(float v, float env) {
    const float a = fabsf(v);
    const float up_in = (1.0f - 0.3f) * a, down_in = (1.0f - 0.01f) * a;
    return fminf(fmaf(0.3f, env, up_in), fmaf(0.01f, env, down_in));
}

AFK_HD float env_scan_log(float env) { return logf(fmaxf(env, 1e-10f)); }

AFK_HD void es_store4(float* p, float4 v) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<float4*>(p) = v;
#else
    p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
#endif
}

// Serial phase of one column over the tc samples of a chunk (a tile column,
// 16-byte aligned, with room for four words past tc): env written over x.
// Returns the env carried to the next chunk.
AFK_HD float env_scan_chunk(float* col, int tc, float env) {
    float4 cur = afk_load4(col);
    int t = 0;
    for (; t + 4 <= tc; t += 4) {
        const float4 next = afk_load4(col + t + 4);
        float4 e;
        e.x = env = env_scan_step(cur.x, env);
        e.y = env = env_scan_step(cur.y, env);
        e.z = env = env_scan_step(cur.z, env);
        e.w = env = env_scan_step(cur.w, env);
        es_store4(col + t, e);
        cur = next;
    }
    if (t < tc) col[t] = env = env_scan_step(cur.x, env);
    if (t + 1 < tc) col[t + 1] = env = env_scan_step(cur.y, env);
    if (t + 2 < tc) col[t + 2] = env = env_scan_step(cur.z, env);
    return env;
}

// Samples chunk k of a T-sample block holds.
AFK_HD int env_scan_rows(int T, int k) { return afk_imin(ES_CHUNK, T - k * ES_CHUNK); }

#ifdef __CUDACC__
// Start the copy of chunk k of the strip into its tile (threads `first` ..
// ES_THREADS - 1), one commit group whatever the thread copied: element
// (r, c) of the time-major strip to column c, sample r. A thread keeps one
// column and walks down it, so its addresses advance by constants.
__device__ __forceinline__ void es_copy(float* tile, const float* x, int T, int B, int b0,
                                        int width, int k, int first) {
    const int i = threadIdx.x - first, c = i % ES_WIDTH;
    const int step = (ES_THREADS - first) / ES_WIDTH;  // rows a pass
    if (k * ES_CHUNK < T && c < width) {
        const int tc = env_scan_rows(T, k);
        const float* src = x + ((long long)k * ES_CHUNK + i / ES_WIDTH) * B + b0 + c;
        float* dst = tile + c * ES_STRIDE + i / ES_WIDTH;
        for (int r = i / ES_WIDTH; r < tc; r += step, src += (long long)step * B, dst += step)
            afk_cp_async4(dst, src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// Parallel phase of chunk k: y = log(max(env, 1e-10)) from its tile, by
// threads `first` .. ES_THREADS - 1, 16-byte stores where rows allow. A
// thread keeps one piece of the row (four columns; one column where rows
// are not 16-byte aligned) and walks down the chunk.
template <bool ALIGNED>
__device__ __forceinline__ void es_log_store(const float* tile, float* y, int T, int B, int b0,
                                             int width, int k, int first) {
    const int tc = env_scan_rows(T, k), i = threadIdx.x - first;
    float* dst = y + (long long)k * ES_CHUNK * B + b0;
    if (ALIGNED) {  // width is a multiple of 4
        const int q = i % ES_QUADS, step = (ES_THREADS - first) / ES_QUADS;
        if (4 * q >= width) return;
        for (int r = i / ES_QUADS; r < tc; r += step) {
            const float* e = tile + 4 * q * ES_STRIDE + r;
            *reinterpret_cast<float4*>(dst + (long long)r * B + 4 * q) =
                make_float4(env_scan_log(e[0]), env_scan_log(e[ES_STRIDE]),
                            env_scan_log(e[2 * ES_STRIDE]), env_scan_log(e[3 * ES_STRIDE]));
        }
    } else {
        const int c = i % ES_WIDTH, step = (ES_THREADS - first) / ES_WIDTH;
        if (c >= width) return;
        for (int r = i / ES_WIDTH; r < tc; r += step)
            dst[(long long)r * B + c] = env_scan_log(tile[c * ES_STRIDE + r]);
    }
}

__device__ __forceinline__ void es_bar_sync(int id) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(ES_THREADS) : "memory");
}

__device__ __forceinline__ void es_bar_arrive(int id) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(ES_THREADS) : "memory");
}

template <bool ALIGNED>
__global__ void __launch_bounds__(ES_THREADS)
env_scan_kernel(const float* __restrict__ x, const float* __restrict__ env_in,
                float* __restrict__ y, float* __restrict__ env_out, int T, int B) {
    __shared__ __align__(16) float ring[ES_STAGES][ES_TILE];
    const int b0 = blockIdx.x * ES_WIDTH;
    const int width = afk_imin(ES_WIDTH, B - b0);
    const int chunks = (T + ES_CHUNK - 1) / ES_CHUNK;
    if (threadIdx.x < 32) {  // serial: lane w runs column w
        const int w = threadIdx.x;
        float env = w < width ? env_in[b0 + w] : 0.0f;
        for (int k = 0; k < chunks; ++k) {
            es_bar_sync(ES_BAR_FULL + (k & 1));
            if (w < width)
                env = env_scan_chunk(ring[k % ES_STAGES] + w * ES_STRIDE, env_scan_rows(T, k),
                                     env);
            __syncwarp();
            es_bar_arrive(ES_BAR_DONE + (k & 1));
        }
        if (chunks > 0)
            es_log_store<ALIGNED>(ring[(chunks - 1) % ES_STAGES], y, T, B, b0, width,
                                  chunks - 1, 0);
        if (w < width) env_out[b0 + w] = env;
        return;
    }
    if (chunks == 0) return;
    for (int k = 0; k < ES_AHEAD; ++k)
        es_copy(ring[k % ES_STAGES], x, T, B, b0, width, k, 32);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(ES_AHEAD - 1));  // chunk 0 landed
    es_bar_arrive(ES_BAR_FULL);
    if (chunks > 1) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(ES_AHEAD - 2));  // chunk 1 landed
        es_bar_arrive(ES_BAR_FULL + 1);
    }
    // Round k: the serial warp has finished chunk k - 1 and starts chunk k.
    for (int k = 1; k <= chunks; ++k) {
        es_bar_sync(ES_BAR_DONE + ((k - 1) & 1));
        if (k + 1 < chunks) {
            asm volatile("cp.async.wait_group %0;\n" ::"n"(ES_AHEAD - 3));  // chunk k + 1 landed
            es_bar_arrive(ES_BAR_FULL + ((k + 1) & 1));
        }
        // its tile held chunk k - 2, logged in the round before
        es_copy(ring[(k - 1 + ES_AHEAD) % ES_STAGES], x, T, B, b0, width, k - 1 + ES_AHEAD, 32);
        es_log_store<ALIGNED>(ring[(k - 1) % ES_STAGES], y, T, B, b0, width, k - 1,
                              k == chunks ? 0 : 32);
    }
}

AFK_API int afk_env_scan(const float* x, const float* env_in, float* y, float* env_out, int T,
                         int B, void* stream) {
    const int blocks = (B + ES_WIDTH - 1) / ES_WIDTH;
    const bool aligned = B % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
    const auto s = static_cast<cudaStream_t>(stream);
    if (aligned)
        env_scan_kernel<true><<<blocks, ES_THREADS, 0, s>>>(x, env_in, y, env_out, T, B);
    else
        env_scan_kernel<false><<<blocks, ES_THREADS, 0, s>>>(x, env_in, y, env_out, T, B);
    return static_cast<int>(cudaGetLastError());
}
#endif

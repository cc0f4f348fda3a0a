// Shared definitions for the hand-written CUDA kernels of audioforge_tpu_torch.
//
// Every kernel keeps its per-stream (or per-lane) sample step in AFK_HD
// functions so the arithmetic is one piece of code that a host C++ build can
// also run; the __global__ wrapper and the extern "C" launcher sit under
// __CUDACC__. The launchers take raw device pointers and a cudaStream_t
// (PyTorch's current stream), allocate nothing, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <cstdint>
#define AFK_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define AFK_HD inline
// The host build's stand-in for CUDA's 16-byte vector, for AFK_HD steps that
// produce a kernel's float4 store.
struct float4 {
    float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
#endif

#define AFK_API extern "C" __attribute__((visibility("default")))

// Threads per block for the one-thread-per-stream kernels: small blocks
// spread a 1024-stream fleet over more SMs.
constexpr int AFK_THREADS = 64;

AFK_HD int afk_imax(int a, int b) { return a > b ? a : b; }
AFK_HD int afk_imin(int a, int b) { return a < b ? a : b; }

// p[0 .. 3]: one 16-byte load on the card (p 16-byte aligned), four on the host.
AFK_HD float4 afk_load4(const float* p) {
#ifdef __CUDA_ARCH__
    return *reinterpret_cast<const float4*>(p);
#else
    return make_float4(p[0], p[1], p[2], p[3]);
#endif
}

// jnp.clip(v, lo, hi) == minimum(maximum(v, lo), hi)
AFK_HD float afk_clip(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

// util.linear_to_db(v, floor_db): max(20 log10(max(|v|, 1e-10)), floor_db)
AFK_HD float afk_linear_to_db(float v, float floor_db) {
    return fmaxf(20.0f * log10f(fmaxf(fabsf(v), 1e-10f)), floor_db);
}

// n / d correctly rounded, as the division rounds it, from rcp = 1 / d
// rounded: n * rcp lies within about an ulp of the quotient and one FMA
// correction rounds it (Markstein). Checked bit for bit against the
// division for every integer d up to 4096 (the longest crossfade) and n up
// to d + 4096 by tests/test_torch_kernel_host.py.
AFK_HD double afk_quotient(double n, double d, double rcp) {
    const double q = n * rcp;
    return fma(fma(-q, d, n), rcp, q);
}

// Hide a value's origin from the optimiser. A recurrence's step picks one of
// two precomputed terms (attack or release), formed off its dependency chain;
// without this the compiler folds the pick back into one term computed after
// the compare, on the chain.
#ifdef __CUDA_ARCH__
#define AFK_KEEP(v) asm("" : "+f"(v))
#else
#define AFK_KEEP(v) ((void)0)
#endif

// Steps t0 .. t0+3 on the values read for them.
template <int NIN, typename Step>
AFK_HD void afk_serial_group(const float (&cur)[NIN][4], int t0, Step& step) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float v[NIN];
#pragma unroll
        for (int i = 0; i < NIN; ++i) v[i] = cur[i][j];
        step(t0 + j, v);
    }
}

// Run step(t, v) for t = 0 .. tc-1 in order with v[i] = in[i][t]: the serial
// loop of a recurrence over rows of a shared-memory tile. The inputs of the
// next four samples are read while the current four step, so no load's
// latency sits on the recurrence's chain. A step may write element t of any
// row, also of an input row: its value for t has been read by then.
template <int NIN, typename Step>
AFK_HD void afk_serial_loop(const float* const (&in)[NIN], int tc, Step& step) {
    float cur[NIN][4], nxt[NIN][4];
    const int end = afk_imax(tc - 1, 0);
#pragma unroll
    for (int i = 0; i < NIN; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cur[i][j] = in[i][afk_imin(j, end)];
    int t0 = 0;
    for (; t0 + 8 <= tc; t0 += 4) {
#pragma unroll
        for (int i = 0; i < NIN; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) nxt[i][j] = in[i][t0 + 4 + j];
        afk_serial_group(cur, t0, step);
#pragma unroll
        for (int i = 0; i < NIN; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cur[i][j] = nxt[i][j];
    }
    if (t0 + 4 <= tc) {  // the last whole group: its read-ahead stays in the chunk
#pragma unroll
        for (int i = 0; i < NIN; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) nxt[i][j] = in[i][afk_imin(t0 + 4 + j, end)];
        afk_serial_group(cur, t0, step);
#pragma unroll
        for (int i = 0; i < NIN; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cur[i][j] = nxt[i][j];
        t0 += 4;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {  // fewer than four are left
        if (t0 + j >= tc) break;
        float v[NIN];
#pragma unroll
        for (int i = 0; i < NIN; ++i) v[i] = cur[i][j];
        step(t0 + j, v);
    }
}

// ---------------------------------------------------------------------------
// Shared-memory tiles of [N, T] stream-major blocks.
//
// A block stages the rows of its streams, one chunk of samples at a time, in
// dynamic shared memory: `rows` rows of `tc` floats at a row stride of
// afk_tile_stride(tc) words. The stride is a multiple of 4 (16-byte rows for
// cp.async and float4 reads) and 4 mod 32, so eight lanes reading a float4 at
// one sample index of eight rows, or 32 lanes reading one word of eight rows,
// hit distinct banks.
// ---------------------------------------------------------------------------

// Dynamic shared memory a tiled kernel may take (set with
// cudaFuncSetAttribute above the 48 KB default).
constexpr int AFK_TILE_SMEM_BYTES = 64 * 1024;

AFK_HD int afk_tile_stride(int tc) {
    const int r4 = (tc + 3) & ~3;
    return r4 + ((4 - (r4 & 31)) & 31);
}

// Longest chunk of a T-sample block whose tile of `rows` rows fits in
// `budget` bytes: a multiple of 4 (chunk starts stay 16-byte aligned), at
// most T.
AFK_HD int afk_tile_chunk(int T, int rows, int budget) {
    const int cap = budget / (4 * rows);  // words per row
    return afk_imin(T, (cap - 28) & ~3);
}

#ifdef __CUDACC__
inline int afk_blocks(int n) { return (n + AFK_THREADS - 1) / AFK_THREADS; }

// Raise `kernel`'s dynamic shared-memory limit where `bytes` needs it.
// `allowed` (a static of the caller, one per kernel) remembers what was set,
// so later launches, also those inside CUDA graph capture, make no
// cudaFuncSetAttribute call.
template <typename Kernel>
inline int afk_allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
    if (bytes <= 48 * 1024 || bytes <= allowed) return 0;
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
    if (err == 0) allowed = bytes;
    return err;
}

__device__ __forceinline__ void afk_cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void afk_cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Rows and chunk starts of `base` are 16-byte aligned: T is a multiple of 4
// and the pointer is.
__device__ __forceinline__ bool afk_rows_aligned(const float* base, int T) {
    return (T & 3) == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
}

// Start the copy of samples [c0, c0 + tc) of `rows` consecutive streams (row
// r at src + r * ld, ld its pitch in floats) into the tile, coalesced:
// neighbouring threads take neighbouring 16-byte pieces of a row (4-byte
// pieces where rows are not 16-byte aligned). afk_tile_wait completes it.
__device__ __forceinline__ void afk_tile_copy(float* tile, int stride, const float* src,
                                              int rows, int ld, int c0, int tc) {
    if (afk_rows_aligned(src, ld)) {
        for (int r = 0; r < rows; ++r)
            for (int j = 4 * threadIdx.x; j < tc; j += 4 * blockDim.x)
                afk_cp_async16(tile + r * stride + j, src + (long long)r * ld + c0 + j);
    } else {
        for (int r = 0; r < rows; ++r)
            for (int j = threadIdx.x; j < tc; j += blockDim.x)
                afk_cp_async4(tile + r * stride + j, src + (long long)r * ld + c0 + j);
    }
}

// Ends with every afk_tile_copy of the block complete and visible to it.
__device__ __forceinline__ void afk_tile_wait() {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
}

// afk_tile_copy of rows of pitch T, complete and visible to the block.
__device__ __forceinline__ void afk_tile_load(float* tile, int stride, const float* src,
                                              int rows, int T, int c0, int tc) {
    afk_tile_copy(tile, stride, src, rows, T, c0, tc);
    afk_tile_wait();
}

// Write the tile back over samples [c0, c0 + tc) of `rows` streams of dst,
// coalesced like afk_tile_load. Starts and ends with a block barrier, so the
// tile is complete before and free for reuse after.
__device__ __forceinline__ void afk_tile_store(const float* tile, int stride, float* dst,
                                               int rows, int T, int c0, int tc) {
    __syncthreads();
    if (afk_rows_aligned(dst, T)) {
        for (int r = 0; r < rows; ++r)
            for (int j = 4 * threadIdx.x; j < tc; j += 4 * blockDim.x)
                *reinterpret_cast<float4*>(dst + (long long)r * T + c0 + j) =
                    *reinterpret_cast<const float4*>(tile + r * stride + j);
    } else {
        for (int r = 0; r < rows; ++r)
            for (int j = threadIdx.x; j < tc; j += blockDim.x)
                dst[(long long)r * T + c0 + j] = tile[r * stride + j];
    }
    __syncthreads();
}
#endif

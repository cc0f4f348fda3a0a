// Shared definitions for the hand-written CUDA kernels of audioforge_tpu_torch.
//
// Every kernel keeps its per-stream sample loop in an AFK_HD function so the
// arithmetic is one piece of code; the __global__ wrapper and the extern "C"
// launcher sit under __CUDACC__. The launchers take raw device pointers and a
// cudaStream_t (PyTorch's current stream), allocate nothing, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define AFK_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define AFK_HD inline
#endif

#define AFK_API extern "C" __attribute__((visibility("default")))

// Threads per block for the one-thread-per-stream kernels: small blocks
// spread a 1024-stream fleet over more SMs.
constexpr int AFK_THREADS = 64;

AFK_HD int afk_imax(int a, int b) { return a > b ? a : b; }

// jnp.clip(v, lo, hi) == minimum(maximum(v, lo), hi)
AFK_HD float afk_clip(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

// util.linear_to_db(v, floor_db): max(20 log10(max(|v|, 1e-10)), floor_db)
AFK_HD float afk_linear_to_db(float v, float floor_db) {
    return fmaxf(20.0f * log10f(fmaxf(fabsf(v), 1e-10f)), floor_db);
}

#ifdef __CUDACC__
inline int afk_blocks(int n) { return (n + AFK_THREADS - 1) / AFK_THREADS; }
#endif

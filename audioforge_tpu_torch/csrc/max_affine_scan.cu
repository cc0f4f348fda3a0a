// max_affine_scan: u_t = max(v_t, rho * u_{t-1} + c_t), one stream per thread.
//
// Replaces the TPU path's blocked associative max-affine scan
// (audioforge_tpu/ops/scan.py:305), which XLA compiled for the lookahead
// limiter (ops/limiter.py:131) and the true-peak limiter (ops/true_peak.py:191).
// On the card the recurrence runs as a plain sequential loop: each thread owns
// one stream's row of the stream-major [N, T] inputs, so loads are strided by
// T across a warp; the loop is bound by the latency of one FMA + max per
// sample, not by bytes (12 bytes in, 4 out per sample).
//
// Unlike jnp.maximum, fmaxf drops a NaN operand; the callers pass finite
// values (the limiters scrub their input first).
#include "afk.cuh"

AFK_HD void max_affine_row(const float* v, const float* c, float* u, int T,
                           float rho, float u0) {
    float s = u0;
    for (int t = 0; t < T; ++t) {
        s = fmaxf(v[t], rho * s + c[t]);
        u[t] = s;
    }
}

#ifdef __CUDACC__
__global__ void max_affine_scan_kernel(const float* __restrict__ v,
                                       const float* __restrict__ c,
                                       const float* __restrict__ rho,
                                       const float* __restrict__ u0,
                                       float* __restrict__ u, int N, int T) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const long long off = (long long)n * T;
    max_affine_row(v + off, c + off, u + off, T, rho[n], u0[n]);
}

AFK_API int afk_max_affine_scan(const float* v, const float* c,
                                const float* rho, const float* u0, float* u,
                                int N, int T, void* stream) {
    max_affine_scan_kernel<<<afk_blocks(N), AFK_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(v, c, rho,
                                                                  u0, u, N, T);
    return static_cast<int>(cudaGetLastError());
}
#endif

// env_scan: one-pole attack/release envelope with a log post-op.
//
// Replaces the Pallas TPU kernel `env_kernel`
// (tools/evaluate_scan_kernel_strategy.py:72-87): per column b and sample t,
//   a = |x[t,b]|; c = a > env ? 0.3 : 0.01; env = c*env + (1-c)*a;
//   y[t,b] = log(max(env, 1e-10)).
// Layout is the tool's time-major [T, B], so thread b reads x[t*B + b] and
// neighbouring threads touch neighbouring addresses (coalesced).
//
// Bound: latency of the sequential per-sample dependency chain (one
// compare/select, one FMA, one log per step); state lives in a register and
// the loop over t runs inside the kernel, which is what the Pallas design
// did with its in-kernel fori_loop.
#include "afk.cuh"

AFK_HD float env_scan_step(float v, float& env) {
    const float a = fabsf(v);
    const float c = a > env ? 0.3f : 0.01f;
    env = c * env + (1.0f - c) * a;
    return logf(fmaxf(env, 1e-10f));
}

// One column of a time-major [T, B] block.
AFK_HD void env_scan_column(const float* x, float* y, int T, int stride,
                            float env_in, float* env_out) {
    float env = env_in;
    for (int t = 0; t < T; ++t) {
        y[(long long)t * stride] = env_scan_step(x[(long long)t * stride], env);
    }
    *env_out = env;
}

#ifdef __CUDACC__
__global__ void env_scan_kernel(const float* __restrict__ x,
                                const float* __restrict__ env_in,
                                float* __restrict__ y,
                                float* __restrict__ env_out, int T, int B) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    env_scan_column(x + b, y + b, T, B, env_in[b], env_out + b);
}

AFK_API int afk_env_scan(const float* x, const float* env_in, float* y,
                         float* env_out, int T, int B, void* stream) {
    env_scan_kernel<<<afk_blocks(B), AFK_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, env_in, y,
                                                           env_out, T, B);
    return static_cast<int>(cudaGetLastError());
}
#endif

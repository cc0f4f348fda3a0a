"""Attack/release envelope with a log post-op over time-major blocks.

Counterpart of the only Pallas kernel of the JAX package, ``env_kernel`` in
``tools/evaluate_scan_kernel_strategy.py:72-87`` (an A/B probe standing for
the chain's sequential envelope stages). Per column ``b`` and sample ``t``::

    a = |x[t, b]|;  c = 0.3 if a > env else 0.01
    env = c * env + (1 - c) * a;  y[t, b] = log(max(env, 1e-10))

:func:`env_scan` launches ``csrc/env_scan.cu`` for a CUDA tensor and runs
the plain twin :func:`env_scan_plain` for a CPU tensor.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = ["env_scan", "env_scan_plain"]


def env_scan_plain(x, env):
    """``x: [T, B]`` time-major, ``env: [B]``. Returns ``(y [T, B], env)``."""
    y = torch.empty_like(x)
    for t in range(x.shape[0]):
        a = x[t].abs()
        c = torch.where(a > env, 0.3, 0.01)
        env = c * env + (1.0 - c) * a
        y[t] = torch.log(torch.clamp_min(env, 1e-10))
    return y, env


def env_scan(x, env):
    """:func:`env_scan_plain` on a CPU tensor; the ``env_scan`` CUDA kernel
    on a CUDA tensor (f32, contiguous)."""
    if x.device.type == "cpu":
        return env_scan_plain(x, env)
    if x.device.type != "cuda":
        raise ValueError(f"env_scan: unsupported device {x.device}")
    T, B = x.shape
    kernels.check_tensor("env_scan x", x, torch.float32, (T, B), x.device)
    kernels.check_tensor("env_scan env", env, torch.float32, (B,), x.device)
    y = torch.empty_like(x)
    env_out = torch.empty_like(env)
    kernels.launch("env_scan", x.data_ptr(), env.data_ptr(), y.data_ptr(),
                   env_out.data_ptr(), T, B, kernels.stream_of(x.device))
    return y, env_out

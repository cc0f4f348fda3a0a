"""Sequential recurrences over the last (time) axis of ``[N, T]`` blocks.

Counterpart of ``audioforge_tpu/ops/scan.py:299-370``. The TPU evaluated
these as blocked associative scans; on the GPU a recurrence is a loop inside
a hand-written kernel, one stream per thread (``csrc/max_affine_scan.cu``).

:func:`max_affine_scan` launches that kernel for a CUDA tensor and runs its
plain PyTorch twin :func:`max_affine_scan_plain` for a CPU tensor.
:func:`sliding_window_max` and :func:`one_pole_scan` are plain PyTorch.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = [
    "max_affine_scan",
    "max_affine_scan_plain",
    "one_pole_scan",
    "sliding_window_max",
]


def _rho_per_stream(rho: torch.Tensor, n: int) -> torch.Tensor:
    return torch.as_tensor(rho, dtype=torch.float32).expand(n)


def max_affine_scan_plain(v, rho, c, u0):
    """``u_t = max(v_t, rho * u_{t-1} + c_t)``; ``v, c: [N, T]``, ``rho``
    ``[N]`` (or a scalar), ``u0: [N]``. Returns ``u: [N, T]``."""
    n, T = v.shape
    rho = _rho_per_stream(rho, n).to(v.device)
    u = torch.empty_like(v)
    s = u0
    for t in range(T):
        s = torch.maximum(v[:, t], rho * s + c[:, t])
        u[:, t] = s
    return u


def max_affine_scan(v, rho, c, u0):
    """:func:`max_affine_scan_plain` on a CPU tensor; the
    ``max_affine_scan`` CUDA kernel on a CUDA tensor (f32, contiguous)."""
    if v.device.type == "cpu":
        return max_affine_scan_plain(v, rho, c, u0)
    if v.device.type != "cuda":
        raise ValueError(f"max_affine_scan: unsupported device {v.device}")
    n, T = v.shape
    rho = _rho_per_stream(rho, n).to(v.device).contiguous()
    for name, t, shape in (("v", v, (n, T)), ("c", c, (n, T)),
                           ("rho", rho, (n,)), ("u0", u0, (n,))):
        kernels.check_tensor(f"max_affine_scan {name}", t, torch.float32,
                             shape, v.device)
    u = torch.empty_like(v)
    kernels.launch("max_affine_scan", v.data_ptr(), c.data_ptr(),
                   rho.data_ptr(), u0.data_ptr(), u.data_ptr(), n, T,
                   kernels.stream_of(v.device))
    return u


def one_pole_scan(x, coeff, y0):
    """``y_t = c_t * y_{t-1} + (1 - c_t) * x_t`` over the last axis."""
    x, coeff = torch.broadcast_tensors(x, coeff)
    y = torch.empty_like(x)
    s = y0
    for t in range(x.shape[-1]):
        s = coeff[..., t] * s + (1.0 - coeff[..., t]) * x[..., t]
        y[..., t] = s
    return y


def sliding_window_max(x, window, init=None):
    """Causal windowed maximum ``y_t = max(x_{t-window+1} .. x_t)``.
    ``init`` supplies the ``window - 1`` samples preceding ``x`` (else
    ``-inf``)."""
    if window <= 1:
        return x
    lead = x.shape[:-1]
    if init is None:
        pad = torch.full(lead + (window - 1,), -torch.inf, dtype=x.dtype,
                         device=x.device)
    else:
        pad = torch.broadcast_to(init, lead + (window - 1,))
    return torch.cat([pad, x], dim=-1).unfold(-1, window, 1).amax(dim=-1)

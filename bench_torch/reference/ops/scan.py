"""Sequential recurrences over the last (time) axis of ``[N, T]`` blocks.

Counterpart of ``audioforge_tpu/ops/scan.py:299-370``. The TPU evaluated
these as blocked associative scans; on the GPU a recurrence is a loop inside
a hand-written kernel over a shared-memory tile of the block, one lane per
stream (``csrc/max_affine_scan.cu``).

:func:`max_affine_scan` launches that kernel for a CUDA tensor and runs its
plain PyTorch twin :func:`max_affine_scan_plain` for a CPU tensor. The
reference's TPU scan machinery has no counterpart here: ``seq_unroll``,
``blocked_associative_scan``, ``affine_scan_2x2`` and
``affine_scan_2x2_compensated`` (the double-word form) exist to turn a
recurrence into parallel work for the TPU's vector units.
:func:`limiter_gain_scan` is the form both limiters call: the same recurrence
with the target gain before it and the gain, the clamped output and the
block's gain statistics after it, one kernel launch on the card
(``limiter_gain_scan`` in the same source) and
:func:`limiter_gain_scan_plain` on the CPU.
:func:`sliding_window_max` and :func:`one_pole_scan` are plain PyTorch.
"""

from __future__ import annotations

import torch




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
    return max_affine_scan_plain(v, rho, c, u0)


def limiter_gain_scan_plain(peak, xd, ceiling, rc, gain0, scale):
    """Plain PyTorch twin of :func:`limiter_gain_scan`."""
    ceil = ceiling[:, None]
    target = torch.where(
        peak > ceil,
        torch.clamp(ceil * scale / torch.clamp_min(peak, 1e-30), 0.0, 1.0), 1.0)
    v = 1.0 - target
    u = max_affine_scan_plain(v, rc, (1.0 - rc)[:, None] * v, 1.0 - gain0)
    gain = 1.0 - u
    y = torch.clamp(xd * gain, -ceil, ceil)
    g_prev = torch.cat([gain0[:, None], gain[:, :-1]], dim=-1)
    events = (target < g_prev).any(dim=-1).to(torch.int32)
    return y, gain[:, -1].contiguous(), gain.amin(dim=-1), events


def limiter_gain_scan(peak, xd, ceiling, rc, gain0, scale):
    """The gain stage of a limiter over a block: instant attack to
    ``target = ceiling * scale / peak`` (clipped to [0, 1]) where the decision
    peak lies above the ceiling, one-pole release by ``rc`` as the max-affine
    recurrence on ``1 - gain`` from ``gain0``, the delayed input times the
    gain, clamped to the ceiling.

    ``peak, xd: f32 [N, T]`` (rows may be windows of a longer row: unit
    stride along T, any row pitch); ``ceiling, rc, gain0: f32 [N]``;
    ``scale``: a float. Returns ``(y [N, T], gain_last [N], min_gain [N],
    events [N] int32)``: the gain after the block's last sample, the block's
    least gain, and 1 where any sample's target lay below the gain of the
    sample before. :func:`limiter_gain_scan_plain` on CPU tensors; the
    ``limiter_gain_scan`` CUDA kernel on CUDA tensors."""
    return limiter_gain_scan_plain(peak, xd, ceiling, rc, gain0, scale)


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

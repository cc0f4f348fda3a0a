"""RBJ biquads and the crossfaded dual-lane unit as one cascade kernel.

Counterpart of ``audioforge_tpu/ops/biquad.py``. The behavioural contract is
the same (RBJ cookbook coefficients designed in f64 on the host and stored as
f32; Direct Form II Transposed; live edits crossfade over 1.5 ms between an
active and a pending lane, then promote the pending lane), but where the TPU
ran one blocked associative scan per section in double-word f32, the GPU runs
every section of a cascade in one hand-written kernel with native f64 state
(``csrc/biquad_cascade.cu``: one lane per section, the sections of a stream
as a wavefront over the block staged in shared memory).

Unit state (stream axis first)::

    coeffs          f32 [N, S, 2, 5]   lane 0 active, lane 1 pending
    z               f64 [N, S, 2, 2]   per-lane (z1, z2)
    fade_total      i32 [N, S]         0 when idle
    fade_remaining  i32 [N, S]

When ``fade_remaining == 0`` the two lanes are identical by construction.

The reference's ``apply`` (a section as a blocked associative scan in
double-word f32, which loses precision across block boundaries: ROADMAP F6)
and ``df2t_step_df32`` (the double-word sample step) have no counterpart:
they exist because the TPU has no f64, and every section here keeps native
f64 state.
"""

from __future__ import annotations

from functools import cache, lru_cache

import numpy as np
import torch

from .. import kernels

__all__ = [
    "BYPASS", "LOW_SHELF", "HIGH_SHELF", "PEAKING", "NOTCH", "HIGH_PASS",
    "LOW_PASS", "MIN_BIQUAD_Q", "COEFF_CROSSFADE_MS",
    "MAX_COEFF_CROSSFADE_SAMPLES", "MAX_KERNEL_SECTIONS",
    "crossfade_samples", "design", "magnitude_response_db", "df2t_step",
    "biquad_cascade", "biquad_cascade_plain", "apply_fixed",
    "unit_init", "unit_schedule", "unit_set_immediate", "unit_reset_state",
    "unit_process",
]

BYPASS = 0
LOW_SHELF = 1
HIGH_SHELF = 2
PEAKING = 3
NOTCH = 4
HIGH_PASS = 5
LOW_PASS = 6

MIN_BIQUAD_Q = 1e-6
COEFF_CROSSFADE_MS = 1.5
MAX_COEFF_CROSSFADE_SAMPLES = 4096
# sections one kernel launch carries (AFK_BIQUAD_MAX_SECTIONS); longer
# cascades are split into several launches
MAX_KERNEL_SECTIONS = 16


def crossfade_samples(sample_rate: float) -> int:
    samples = round(float(sample_rate) * COEFF_CROSSFADE_MS / 1000.0)
    if not np.isfinite(samples):
        return 1
    return int(min(max(samples, 1), MAX_COEFF_CROSSFADE_SAMPLES))


def design(filter_type, frequency, gain_db, q, sample_rate):
    """Host f64 RBJ coefficients ``[..., 5] = [b0, b1, b2, a1, a2]``,
    normalised so ``a0 = 1`` (copied from the reference package)."""
    ft = np.asarray(filter_type)
    freq = np.asarray(frequency, dtype=np.float64)
    gain = np.asarray(gain_db, dtype=np.float64)
    qv = np.maximum(np.asarray(q, dtype=np.float64), MIN_BIQUAD_Q)

    omega = 2.0 * np.pi * freq / sample_rate
    sin_w = np.sin(omega)
    cos_w = np.cos(omega)
    alpha = sin_w / (2.0 * qv)
    a = np.power(10.0, gain / 40.0)
    sqrt_a2alpha = 2.0 * np.sqrt(a) * alpha
    one = np.ones_like(cos_w)
    zero = np.zeros_like(cos_w)

    def norm(b0, b1, b2, a0, a1, a2):
        return np.stack([b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0], axis=-1)

    peaking = norm(1.0 + alpha * a, -2.0 * cos_w, 1.0 - alpha * a,
                   1.0 + alpha / a, -2.0 * cos_w, 1.0 - alpha / a)
    low_shelf = norm(
        a * ((a + 1.0) - (a - 1.0) * cos_w + sqrt_a2alpha),
        2.0 * a * ((a - 1.0) - (a + 1.0) * cos_w),
        a * ((a + 1.0) - (a - 1.0) * cos_w - sqrt_a2alpha),
        (a + 1.0) + (a - 1.0) * cos_w + sqrt_a2alpha,
        -2.0 * ((a - 1.0) + (a + 1.0) * cos_w),
        (a + 1.0) + (a - 1.0) * cos_w - sqrt_a2alpha,
    )
    high_shelf = norm(
        a * ((a + 1.0) + (a - 1.0) * cos_w + sqrt_a2alpha),
        -2.0 * a * ((a - 1.0) + (a + 1.0) * cos_w),
        a * ((a + 1.0) + (a - 1.0) * cos_w - sqrt_a2alpha),
        (a + 1.0) - (a - 1.0) * cos_w + sqrt_a2alpha,
        2.0 * ((a - 1.0) - (a + 1.0) * cos_w),
        (a + 1.0) - (a - 1.0) * cos_w - sqrt_a2alpha,
    )
    notch = norm(one, -2.0 * cos_w, one, 1.0 + alpha, -2.0 * cos_w, 1.0 - alpha)
    high_pass = norm((1.0 + cos_w) / 2.0, -(1.0 + cos_w), (1.0 + cos_w) / 2.0,
                     1.0 + alpha, -2.0 * cos_w, 1.0 - alpha)
    low_pass = norm((1.0 - cos_w) / 2.0, 1.0 - cos_w, (1.0 - cos_w) / 2.0,
                    1.0 + alpha, -2.0 * cos_w, 1.0 - alpha)
    out = np.stack([one, zero, zero, zero, zero], axis=-1)
    ft_b = ft[..., None]
    for code, coeffs in ((LOW_SHELF, low_shelf), (HIGH_SHELF, high_shelf),
                         (PEAKING, peaking), (NOTCH, notch),
                         (HIGH_PASS, high_pass), (LOW_PASS, low_pass)):
        out = np.where(ft_b == code, coeffs, out)
    return out


def magnitude_response_db(coeffs, frequencies, sample_rate) -> np.ndarray:
    """Exact |H| in dB (host f64) at ``frequencies`` for coefficients
    ``[..., 5]``; the result has shape ``coeffs.shape[:-1] +
    frequencies.shape``."""
    c = np.asarray(coeffs, np.float64)
    freqs = np.asarray(frequencies, np.float64)
    shape = c.shape[:-1] + (1,) * freqs.ndim
    b0, b1, b2, a1, a2 = (c[..., i].reshape(shape) for i in range(5))
    omega = 2.0 * np.pi * freqs / sample_rate
    cw, sw = np.cos(omega), np.sin(omega)
    c2w, s2w = np.cos(2.0 * omega), np.sin(2.0 * omega)
    num_re = b0 + b1 * cw + b2 * c2w
    num_im = -b1 * sw - b2 * s2w
    den_re = 1.0 + a1 * cw + a2 * c2w
    den_im = -a1 * sw - a2 * s2w
    num_p = num_re * num_re + num_im * num_im
    den_p = den_re * den_re + den_im * den_im
    eps = 1e-30
    return 10.0 * np.log10(np.maximum(num_p, eps) / np.maximum(den_p, eps))


def df2t_step(coeffs, z1, z2, x_t):
    """One DF2T sample on broadcastable tensors: ``coeffs [..., 5]``.
    Returns ``(y, z1', z2')``."""
    b0, b1, b2, a1, a2 = coeffs.unbind(-1)
    y = b0 * x_t + z1
    return y, b1 * x_t - a1 * y + z2, b2 * x_t - a2 * y


# --------------------------------------------------------------------------
# The cascade: kernel wrapper and its plain twin
# --------------------------------------------------------------------------


# samples one block operator of the plain twin covers
_OPERATOR_CHUNK = 256


@lru_cache(maxsize=128)
def _section_operators(coeffs: tuple, length: int, device: torch.device):
    """f64 operators of one static DF2T section over ``length`` samples, for
    rows ``x [.., L]`` and states ``z [.., 2]``: ``y = x @ HT + z @ Z2Y`` and
    ``z_end = x @ X2Z + z @ AT``. The state advances ``z' = A z + B x`` with
    ``y = b0 x + z1``."""
    b0, b1, b2, a1, a2 = coeffs
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    B = np.array([b1 - a1 * b0, b2 - a2 * b0])
    powers = np.empty((length + 1, 2, 2))
    powers[0] = np.eye(2)
    for k in range(1, length + 1):
        powers[k] = A @ powers[k - 1]
    h = np.empty(length)  # impulse response
    h[0] = b0
    h[1:] = powers[:length - 1, 0, :] @ B
    i = np.arange(length)
    lag = i[None, :] - i[:, None]
    HT = np.where(lag >= 0, h[np.clip(lag, 0, None)], 0.0)
    X2Z = powers[length - 1 - i] @ B  # [L, 2]
    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                                    device=device)
    return f64(HT), f64(powers[:length, 0, :].T), f64(X2Z), f64(powers[length].T)


def _static_section(coeffs: tuple, v, z0):
    """One static section over ``v: f64 [n, T]`` from states ``z0 [n, 2]``,
    chunk by chunk. Returns ``(y, z_end)``."""
    y = torch.empty_like(v)
    z = z0
    T = v.shape[-1]
    for lo in range(0, T, _OPERATOR_CHUNK):
        hi = min(lo + _OPERATOR_CHUNK, T)
        HT, Z2Y, X2Z, AT = _section_operators(coeffs, hi - lo, v.device)
        xc = v[:, lo:hi]
        y[:, lo:hi] = xc @ HT + z @ Z2Y
        z = xc @ X2Z + z @ AT
    return y, z


def _shared_rows(c: torch.Tensor):
    """The row every stream shares in ``c [N, 5]`` as a tuple, else None."""
    first = c[:1]
    return tuple(first[0].tolist()) if bool((c == first).all()) else None


def biquad_cascade_plain(x, coeffs, z, fade_total, fade_remaining):
    """Plain PyTorch twin of the ``biquad_cascade`` kernel (f64 state and
    arithmetic).

    ``x: f32 [N, T]``, ``coeffs: f32 [N, S, 2, 5]``, ``z: f64 [N, S, 2, 2]``,
    ``fade_total / fade_remaining: i32 [N, S]``. Returns
    ``(y f32 [N, T], z_out f64 [N, S, 2, 2])``; promotion is the caller's.

    A section whose lane coefficients every stream shares (the EQ, the
    meters' K-weighting, the fixed high-passes) runs as exact linear block
    operators (impulse response, state-to-output and state propagation, f64)
    over chunks of the block; otherwise the sections run as the kernel runs
    them, a wavefront of per-sample DF2T steps."""
    n, T = x.shape
    S = coeffs.shape[1]
    if S == 0:
        return x, z.clone()
    c64 = coeffs.to(torch.float64)
    fading = fade_remaining > 0  # [N, S]
    lane1_needed = [bool(fading[:, s].any()) for s in range(S)]
    shared = [(_shared_rows(c64[:, s, 0]),
               _shared_rows(c64[:, s, 1]) if lane1_needed[s] else ())
              for s in range(S)]
    if any(a is None or b is None for a, b in shared):
        return _cascade_wavefront(x, c64, z, fade_total, fade_remaining)
    v = x.to(torch.float64)
    t_idx = torch.arange(T, dtype=torch.float64, device=x.device)
    z_out = torch.empty_like(z)
    for s in range(S):
        y0, z0 = _static_section(shared[s][0], v, z[:, s, 0])
        z_out[:, s, 0] = z0
        if not lane1_needed[s]:
            z_out[:, s, 1] = z0
            v = y0
            continue
        y1, z1 = _static_section(shared[s][1], v, z[:, s, 1])
        total = fade_total[:, s, None].to(torch.float64)
        done = (fade_total[:, s] - fade_remaining[:, s])[:, None].to(torch.float64) + 1.0
        w = torch.where(total > 0, ((done + t_idx) / total.clamp_min(1.0)).clamp(0.0, 1.0),
                        1.0)
        fade = fading[:, s, None]
        v = torch.where(fade, (1.0 - w) * y0 + w * y1, y0)
        z_out[:, s, 1] = torch.where(fade, z1, z0)
    return v.to(torch.float32), z_out


def _cascade_wavefront(x, c64, z, fade_total, fade_remaining):
    """The cascade as a wavefront of per-sample DF2T steps: at step k section
    s filters sample k - s, its input the output section s - 1 made at the
    step before."""
    n, T = x.shape
    S = c64.shape[1]
    f64 = torch.float64
    b0, b1, b2, a1, a2 = c64.unbind(-1)  # [N, S, 2] each
    v = x.to(f64)
    z1, z2 = z[..., 0].clone(), z[..., 1].clone()  # [N, S, 2]
    # crossfade weight of section s at its sample t
    t_idx = torch.arange(T, dtype=f64, device=x.device)
    total = fade_total.to(f64)[..., None]
    done = (fade_total - fade_remaining).to(f64)[..., None] + 1.0
    w = torch.where(total > 0, ((done + t_idx) / total.clamp_min(1.0)).clamp(0.0, 1.0),
                    1.0)  # [N, S, T]
    fading = fade_remaining > 0  # [N, S]
    any_fading = bool(fading.any())
    sec = torch.arange(S, device=x.device)
    out_prev = torch.zeros((n, S), dtype=f64, device=x.device)
    y = torch.empty((n, T), dtype=f64, device=x.device)
    zero = torch.zeros((n, 1), dtype=f64, device=x.device)
    for k in range(T + S - 1):
        head = v[:, k:k + 1] if k < T else zero
        inp = torch.cat([head, out_prev[:, :-1]], dim=1)[..., None]  # [N, S, 1]
        yl = b0 * inp + z1
        live = ((k - sec >= 0) & (k - sec < T))[:, None]  # [S, 1]
        z1, z2 = (torch.where(live, b1 * inp - a1 * yl + z2, z1),
                  torch.where(live, b2 * inp - a2 * yl, z2))
        if any_fading:
            wk = w.gather(2, (k - sec).clamp(0, T - 1).expand(n, S)[..., None])[..., 0]
            out_prev = torch.where(fading, (1.0 - wk) * yl[..., 0] + wk * yl[..., 1],
                                   yl[..., 0])
        else:
            out_prev = yl[..., 0]
        if k >= S - 1:
            y[:, k - S + 1] = out_prev[:, S - 1]
    lane0 = torch.stack([z1[..., 0], z2[..., 0]], -1)
    lane1 = torch.where(fading[..., None], torch.stack([z1[..., 1], z2[..., 1]], -1),
                        lane0)
    return y.to(torch.float32), torch.stack([lane0, lane1], dim=2)


def _cascade_launch(x, coeffs, z, fade_total, fade_remaining):
    n, T = x.shape
    S = coeffs.shape[1]
    dev = x.device
    kernels.check_tensor("biquad_cascade x", x, torch.float32, (n, T), dev)
    kernels.check_tensor("biquad_cascade coeffs", coeffs, torch.float32,
                         (n, S, 2, 5), dev)
    kernels.check_tensor("biquad_cascade z", z, torch.float64, (n, S, 2, 2), dev)
    for name, t in (("fade_total", fade_total), ("fade_remaining", fade_remaining)):
        kernels.check_tensor(f"biquad_cascade {name}", t, torch.int32, (n, S), dev)
    y = torch.empty_like(x)
    z_out = torch.empty_like(z)
    kernels.launch("biquad_cascade", x.data_ptr(), coeffs.data_ptr(),
                   z.data_ptr(), fade_total.data_ptr(),
                   fade_remaining.data_ptr(), y.data_ptr(), z_out.data_ptr(),
                   n, S, T, kernels.stream_of(dev))
    return y, z_out


def biquad_cascade(x, coeffs, z, fade_total, fade_remaining):
    """Run a block through a crossfaded cascade: :func:`biquad_cascade_plain`
    for a CPU tensor, the ``biquad_cascade`` CUDA kernel for a CUDA tensor
    (one launch per :data:`MAX_KERNEL_SECTIONS` sections)."""
    if x.device.type == "cpu":
        return biquad_cascade_plain(x, coeffs, z, fade_total, fade_remaining)
    if x.device.type != "cuda":
        raise ValueError(f"biquad_cascade: unsupported device {x.device}")
    S = coeffs.shape[1]
    if S <= MAX_KERNEL_SECTIONS:
        return _cascade_launch(x, coeffs, z, fade_total, fade_remaining)
    y, parts = x, []
    for lo in range(0, S, MAX_KERNEL_SECTIONS):
        sl = slice(lo, lo + MAX_KERNEL_SECTIONS)
        y, zp = _cascade_launch(y, coeffs[:, sl].contiguous(),
                                z[:, sl].contiguous(),
                                fade_total[:, sl].contiguous(),
                                fade_remaining[:, sl].contiguous())
        parts.append(zp)
    return y, torch.cat(parts, dim=1)


def _dual_lane(c: torch.Tensor, n: int) -> torch.Tensor:
    """``[S, 5]`` -> identical lanes for every stream, ``[n, S, 2, 5]``."""
    return c.reshape(-1, 1, 5).expand(n, -1, 2, 5).contiguous()


# device constants are cached without bound: the serving engine's captured
# CUDA graph reads them by address, so an entry dropped from the cache would be
# freed under it
@cache
def _host_coeffs(key: tuple, n: int, device: torch.device) -> torch.Tensor:
    return _dual_lane(torch.tensor(key, dtype=torch.float32, device=device), n)


@cache
def _idle_fades(n: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.zeros((n, s), dtype=torch.int32, device=device)


def apply_fixed(coeffs, z, x):
    """Filter ``x: f32 [N, T]`` through a cascade of STATIC sections with
    single-lane f64 state ``z: [N, S, 2]``. ``coeffs`` is ``(S, 5)``: host
    floats, or an f32 tensor shared by every stream. One cascade launch;
    returns ``(y, z_out)``."""
    n = x.shape[0]
    if isinstance(coeffs, torch.Tensor):
        c = _dual_lane(coeffs.to(device=x.device, dtype=torch.float32), n)
    else:
        key = tuple(float(v) for v in np.asarray(coeffs, np.float64).reshape(-1))
        c = _host_coeffs(key, n, x.device)
    idle = _idle_fades(n, c.shape[1], x.device)
    y, z_out = biquad_cascade(x, c, torch.stack([z, z], dim=2), idle, idle)
    return y, z_out[:, :, 0].contiguous()


# --------------------------------------------------------------------------
# Crossfaded unit
# --------------------------------------------------------------------------


def unit_init(coeffs, n: int, device) -> dict:
    """State for ``n`` streams starting at host ``coeffs`` ``(S, 5)``."""
    c = torch.as_tensor(np.asarray(coeffs, np.float32), device=device)
    lanes = torch.stack([c, c], dim=-2).expand(n, -1, 2, 5).contiguous()
    S = c.shape[0]
    return {
        "coeffs": lanes,
        "z": torch.zeros((n, S, 2, 2), dtype=torch.float64, device=device),
        "fade_total": torch.zeros((n, S), dtype=torch.int32, device=device),
        "fade_remaining": torch.zeros((n, S), dtype=torch.int32, device=device),
    }


def unit_schedule(state, new_coeffs, fade_samples: int) -> dict:
    """Crossfade every section of ``state`` to ``new_coeffs`` (broadcastable
    to ``[N, S, 5]``): the pending lane starts from the active lane's state."""
    coeffs = state["coeffs"].clone()
    coeffs[:, :, 1] = torch.as_tensor(new_coeffs, dtype=torch.float32,
                                      device=coeffs.device)
    z = state["z"].clone()
    z[:, :, 1] = z[:, :, 0]
    total = torch.full_like(state["fade_total"], int(fade_samples))
    return {"coeffs": coeffs, "z": z, "fade_total": total,
            "fade_remaining": total.clone()}


def unit_set_immediate(state, new_coeffs) -> dict:
    """Commit ``new_coeffs`` (broadcastable to ``[N, S, 5]``) to both lanes
    with no crossfade, keeping the active lane's filter state
    (`biquad.rs:230-246`)."""
    coeffs = state["coeffs"]
    new_c = torch.as_tensor(new_coeffs, dtype=torch.float32,
                            device=coeffs.device).expand_as(coeffs[:, :, 0])
    z0 = state["z"][:, :, 0]
    return {"coeffs": torch.stack([new_c, new_c], dim=2),
            "z": torch.stack([z0, z0], dim=2),
            "fade_total": torch.zeros_like(state["fade_total"]),
            "fade_remaining": torch.zeros_like(state["fade_remaining"])}


def unit_reset_state(state) -> dict:
    """Clear the filter state and commit any pending target
    (`biquad.rs:341-347`)."""
    target = state["coeffs"][:, :, 1]
    return {"coeffs": torch.stack([target, target], dim=2),
            "z": torch.zeros_like(state["z"]),
            "fade_total": torch.zeros_like(state["fade_total"]),
            "fade_remaining": torch.zeros_like(state["fade_remaining"])}


def unit_process(state, x):
    """Run ``x: f32 [N, T]`` through the unit's cascade and promote every
    section whose crossfade ended in this block. Returns ``(state, y)``."""
    coeffs, total, remaining = (state["coeffs"], state["fade_total"],
                                state["fade_remaining"])
    y, z_out = biquad_cascade(x, coeffs, state["z"], total, remaining)
    new_remaining = torch.clamp_min(remaining - x.shape[-1], 0)
    promoted = (remaining > 0) & (new_remaining == 0)
    pm = promoted[..., None]
    active_c = torch.where(pm, coeffs[:, :, 1], coeffs[:, :, 0])
    active_z = torch.where(pm, z_out[:, :, 1], z_out[:, :, 0])
    new_state = {
        "coeffs": torch.stack([active_c, coeffs[:, :, 1]], dim=2),
        "z": torch.stack([active_z, z_out[:, :, 1]], dim=2),
        "fade_total": torch.where(promoted, 0, total).to(torch.int32),
        "fade_remaining": new_remaining.to(torch.int32),
    }
    return new_state, y

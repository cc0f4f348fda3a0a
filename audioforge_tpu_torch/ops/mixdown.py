"""Input channel mixdown, including phase-safe mono rescue.

A copy of ``audioforge_tpu/ops/mixdown.py`` (numpy, behaviour unchanged).
Mirrors `rust-core/src/audio/input.rs:23-56,83-133,424-651`:

- Channel modes Average / Left / Right / MaxRms / PhaseSafeMono
  (`input.rs:136-177`).
- **Phase-safe mono**: per-block stereo correlation; a ±8-sample delay x
  polarity scan picks the best alignment (accepted only above 0.35
  correlation and a 0.04 improvement), refined to sub-sample precision with
  a parabolic fit; rescue strategies PolarityFlip (|delay| < 0.25),
  FractionalDelay (4-point Lagrange/Farrow on a 16-sample history, both
  channels get the 2-sample causal base latency), and MaxRmsFallback when
  correlation stays below -0.75 with no usable alignment.
- Correlation-aware mix gain ``1/(2*sqrt(0.5+0.5*max(corr,0)))`` clamped to
  [0.5, 1/sqrt(2)] (`input.rs:596-597`).

This is the host ingest shim's kernel — it conditions the capture callback
stream before framing for the device — so it is vectorised numpy: the
delay scan is one batched masked dot product and the Lagrange alignment is
a constant-coefficient 4-tap filter per block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "INPUT_PHASE_WARNING_CORRELATION",
    "PhaseAlignmentCandidate",
    "PhaseSafeMonoState",
    "best_phase_alignment",
    "mix_phase_safe",
    "mix_to_mono",
    "stereo_correlation",
]

INPUT_PHASE_WARNING_CORRELATION = -0.75
MAX_DELAY_SAMPLES = 8
MIN_CORRELATION = 0.35
MIN_IMPROVEMENT = 0.04
HISTORY_SAMPLES = 16
INTERPOLATION_LATENCY = 2.0

STRATEGY_NONE = "none"
STRATEGY_POLARITY_FLIP = "polarity_flip"
STRATEGY_FRACTIONAL_DELAY = "fractional_delay"
STRATEGY_MAX_RMS_FALLBACK = "max_rms_fallback"


@dataclass(frozen=True)
class PhaseAlignmentCandidate:
    strategy: str
    delay_samples: float
    polarity: float
    correlation: float


def stereo_correlation(left, right):
    """Normalised L/R correlation; None for silent blocks
    (`input.rs:424-450`)."""
    left = np.asarray(left, np.float32)
    right = np.asarray(right, np.float32)
    if left.size == 0:
        return None
    denom = float(np.sqrt(np.dot(left, left) * np.dot(right, right)))
    if denom <= np.finfo(np.float32).eps:
        return None
    return float(np.clip(np.dot(left, right) / denom, -1.0, 1.0))


def _delayed_correlations(left, right, delays):
    """Correlation of left[i] with right[i+delay] for each delay, one
    vectorised pass (the reference's per-delay loops, `input.rs:452-489`).
    Returns an array with NaN where the overlap is under 3 samples."""
    n = left.size
    out = np.full(len(delays), np.nan, np.float64)
    for j, d in enumerate(delays):
        start = -d if d < 0 else 0
        end = n - d if d > 0 else n
        if end - start < 3:
            continue
        seg_l = left[start:end]
        seg_r = right[start + d : end + d]
        denom = np.sqrt(np.dot(seg_l, seg_l) * np.dot(seg_r, seg_r))
        if denom <= np.finfo(np.float32).eps:
            continue
        out[j] = np.clip(np.dot(seg_l, seg_r) / denom, -1.0, 1.0)
    return out


def best_phase_alignment(left, right, current_correlation: float):
    """Delay x polarity scan with parabolic refinement
    (`input.rs:491-551`). Returns a candidate or None."""
    left = np.asarray(left, np.float64)
    right = np.asarray(right, np.float64)
    delays = np.arange(-MAX_DELAY_SAMPLES, MAX_DELAY_SAMPLES + 1)
    corr_pos = _delayed_correlations(left, right, delays)
    # negative polarity correlates against -right: corr flips sign
    corr_neg = -corr_pos

    best = (-np.inf, 0, 1.0)
    for polarity, corrs in ((1.0, corr_pos), (-1.0, corr_neg)):
        finite = np.where(np.isnan(corrs), -np.inf, corrs)
        j = int(np.argmax(finite))
        if finite[j] > best[0]:
            best = (float(finite[j]), int(delays[j]), polarity)
    best_corr, best_delay, best_polarity = best

    if (best_corr < MIN_CORRELATION
            or best_corr - current_correlation < MIN_IMPROVEMENT):
        return None

    refined = float(best_delay)
    if -MAX_DELAY_SAMPLES < best_delay < MAX_DELAY_SAMPLES:
        tri = _delayed_correlations(
            left, right, [best_delay - 1, best_delay, best_delay + 1]
        ) * best_polarity
        if not np.any(np.isnan(tri)):
            prev, center, nxt = tri
            denom = prev - 2.0 * center + nxt
            if abs(denom) > 1e-6:
                refined += float(np.clip(0.5 * (prev - nxt) / denom, -0.5, 0.5))

    strategy = (
        STRATEGY_POLARITY_FLIP
        if best_polarity < 0.0 and abs(refined) < 0.25
        else STRATEGY_FRACTIONAL_DELAY
    )
    return PhaseAlignmentCandidate(strategy, refined, best_polarity, best_corr)


def _lagrange_taps(delay: float):
    """4-point Lagrange weights and integer anchor for a fractional delay
    (`input.rs:120-133`). Returns (anchor, [w for x[a+1], x[a], x[a-1],
    x[a-2]]) in newest-first history indexing."""
    delay = float(np.clip(delay, 2.0, HISTORY_SAMPLES - 3))
    anchor = int(np.ceil(delay))
    t = anchor - delay
    w = np.array([
        -t * (t - 1.0) * (t - 2.0) / 6.0,
        (t + 1.0) * (t - 1.0) * (t - 2.0) / 2.0,
        -(t + 1.0) * t * (t - 2.0) / 2.0,
        (t + 1.0) * t * (t - 1.0) / 6.0,
    ], np.float32)
    return anchor, w


class PhaseSafeMonoState:
    """Persistent cross-block alignment state (`input.rs:83-110`)."""

    def __init__(self):
        self.left_history = np.zeros(HISTORY_SAMPLES, np.float32)
        self.right_history = np.zeros(HISTORY_SAMPLES, np.float32)
        self.filled = 0
        self.last_candidate: PhaseAlignmentCandidate | None = None


def _aligned_channel(history, block, delay: float):
    """Delay ``block`` by a constant fractional amount using its own
    history: newest-first history is prepended, and the per-sample
    Lagrange evaluation collapses to a constant 4-tap FIR."""
    anchor, w = _lagrange_taps(delay)
    # sequence oldest-first: [history reversed, block]
    seq = np.concatenate([history[::-1], block])
    n = block.size
    base = history.size + np.arange(n)
    # history index k maps to seq position (pos - k); taps at
    # anchor+1, anchor, anchor-1, anchor-2 behind the current sample
    out = (
        w[0] * seq[base - (anchor + 1)]
        + w[1] * seq[base - anchor]
        + w[2] * seq[base - (anchor - 1)]
        + w[3] * seq[base - (anchor - 2)]
    )
    return out.astype(np.float32)


def mix_phase_safe(left, right, state: PhaseSafeMonoState):
    """Phase-safe stereo mixdown of one block (`input.rs:554-651`).

    Returns ``(mono, diagnostics)`` where diagnostics is a dict with
    strategy / estimated_delay_samples / polarity_flipped / correlation.
    """
    left = np.asarray(left, np.float32)
    right = np.asarray(right, np.float32)
    n = left.size
    corr = stereo_correlation(left, right)
    current = 1.0 if corr is None else corr

    detected = best_phase_alignment(left, right, current)
    if detected is not None:
        state.last_candidate = detected
    elif current >= INPUT_PHASE_WARNING_CORRELATION:
        state.last_candidate = None
    candidate = detected or state.last_candidate

    def push_history():
        if n >= HISTORY_SAMPLES:
            state.left_history = left[-HISTORY_SAMPLES:][::-1].copy()
            state.right_history = right[-HISTORY_SAMPLES:][::-1].copy()
        else:
            state.left_history = np.concatenate(
                [left[::-1], state.left_history]
            )[:HISTORY_SAMPLES]
            state.right_history = np.concatenate(
                [right[::-1], state.right_history]
            )[:HISTORY_SAMPLES]
        state.filled = min(state.filled + n, HISTORY_SAMPLES)

    if candidate is None:
        push_history()
        if current < INPUT_PHASE_WARNING_CORRELATION:
            # hard out-of-phase with no alignment: keep the stronger channel
            pick_left = float(np.dot(left, left)) >= float(np.dot(right, right))
            mono = left if pick_left else right
            return mono.copy(), {
                "strategy": STRATEGY_MAX_RMS_FALLBACK,
                "estimated_delay_samples": 0.0,
                "polarity_flipped": False,
                "correlation": current,
            }
        return (0.5 * (left + right)).astype(np.float32), {
            "strategy": STRATEGY_NONE,
            "estimated_delay_samples": 0.0,
            "polarity_flipped": False,
            "correlation": current,
        }

    mix_gain = float(np.clip(
        1.0 / (2.0 * np.sqrt(0.5 + 0.5 * max(candidate.correlation, 0.0))),
        0.5, 1.0 / np.sqrt(2.0),
    ))

    if candidate.strategy == STRATEGY_POLARITY_FLIP:
        mono = (left + right * candidate.polarity) * mix_gain
        push_history()
        return mono.astype(np.float32), {
            "strategy": candidate.strategy,
            "estimated_delay_samples": candidate.delay_samples,
            "polarity_flipped": candidate.polarity < 0.0,
            "correlation": candidate.correlation,
        }

    # fractional-delay alignment: the lagging channel gets only the causal
    # base latency; the leading one gets base + estimated delay
    filled_before = state.filled
    if candidate.delay_samples >= 0.0:
        al = _aligned_channel(
            state.left_history, left,
            INTERPOLATION_LATENCY + candidate.delay_samples,
        )
        ar = _aligned_channel(state.right_history, right, INTERPOLATION_LATENCY)
    else:
        al = _aligned_channel(state.left_history, left, INTERPOLATION_LATENCY)
        ar = _aligned_channel(
            state.right_history, right,
            INTERPOLATION_LATENCY - candidate.delay_samples,
        )
    mono = (al + ar * candidate.polarity) * mix_gain

    # warm-up: until the history holds enough context, pass the stronger
    # sample through (`input.rs:609-617`)
    required = int(np.ceil(
        INTERPOLATION_LATENCY + abs(candidate.delay_samples)
    )) + 2
    warm = max(0, min(n, required - filled_before))
    if warm > 0:
        stronger = np.where(
            np.abs(left[:warm]) >= np.abs(right[:warm]),
            left[:warm], right[:warm],
        )
        mono = mono.copy()
        mono[:warm] = stronger
    push_history()
    return mono.astype(np.float32), {
        "strategy": candidate.strategy,
        "estimated_delay_samples": candidate.delay_samples,
        "polarity_flipped": candidate.polarity < 0.0,
        "correlation": candidate.correlation,
    }


def mix_to_mono(left, right, mode: str, state: PhaseSafeMonoState | None = None):
    """Channel mixdown entry (`input.rs:136-177`). Returns
    ``(mono, correlation_or_None, diagnostics)``."""
    left = np.asarray(left, np.float32)
    right = np.asarray(right, np.float32)
    corr = stereo_correlation(left, right)
    none_diag = {
        "strategy": STRATEGY_NONE,
        "estimated_delay_samples": 0.0,
        "polarity_flipped": False,
        "correlation": 1.0 if corr is None else corr,
    }
    if mode == "left":
        return left.copy(), corr, none_diag
    if mode == "right":
        return right.copy(), corr, none_diag
    if mode == "max_rms":
        pick_left = float(np.dot(left, left)) >= float(np.dot(right, right))
        return (left if pick_left else right).copy(), corr, none_diag
    if mode == "phase_safe_mono":
        if state is None:
            state = PhaseSafeMonoState()
        mono, diag = mix_phase_safe(left, right, state)
        return mono, corr, diag
    return (0.5 * (left + right)).astype(np.float32), corr, none_diag

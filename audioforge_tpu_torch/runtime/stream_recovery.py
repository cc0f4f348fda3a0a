"""Stream-recovery decision heuristics (supervisor side, headless).

A copy of ``audioforge_tpu/ui_logic/stream_recovery.py`` (plain Python,
behaviour unchanged) for the engine's supervisor thread.

Behavioral contract of `python/mic_eq/ui/stream_recovery.py` plus the input
half of the reference supervisor's dual heartbeat watch
(`supervisor.rs:22-98`): three sustained-condition detectors polled by the
supervisor timer. Each follows the same shape — a *suspicion* predicate must
hold continuously past a grace period, inside a warmup window after start
and a cooldown window after the last recovery — but they differ in which
gates clear the armed timer, and those differences are part of the contract:

- **output stall** (`stream_recovery.py:69-103`): live input, silent output,
  swollen output buffer; any failed gate disarms the timer.
- **callback stall** (`stream_recovery.py:9-46`): output callback aging out
  while the input callback stays fresh; any failed gate disarms.
- **input stall**: input callback heartbeat aged past 2.5 s; warmup and
  cooldown pause the clock WITHOUT disarming (a stall spanning the cooldown
  boundary keeps its arm time).

When a detector fires, the caller invokes
:meth:`..runtime.processor.AudioProcessor.service_recovery`.
"""

from __future__ import annotations

import time

__all__ = ["StreamRecoveryManager", "update_callback_stall_state"]

# shared timing policy (seconds / milliseconds)
_WARMUP_S = 5.0
_COOLDOWN_S = 20.0
_GRACE_S = 1.5
_OUTPUT_CB_AGE_MS = 2000
_INPUT_CB_FRESH_MS = 1500
_INPUT_CB_STALL_MS = 2500
_LIVE_INPUT_RMS_DB = -50.0
_SILENT_OUTPUT_RMS_DB = -85.0
_SWOLLEN_OUTPUT_BUF = 20000


class _StallTimer:
    """Grace-period integrator: ``advance`` arms on the first suspicious
    poll and reports True once the suspicion has been held past ``grace``
    (self-disarming on fire); ``disarm`` resets."""

    __slots__ = ("armed_at",)

    def __init__(self):
        self.armed_at = None

    def disarm(self) -> None:
        self.armed_at = None

    def advance(self, now: float, grace_s: float) -> bool:
        if self.armed_at is None:
            self.armed_at = now
            return False
        if now - self.armed_at < grace_s:
            return False
        self.armed_at = None
        return True


def update_callback_stall_state(
    stall_started_at,
    now: float,
    input_cb_age_ms: int,
    output_cb_age_ms: int,
    processing_started_at,
    last_recovery_at: float,
    calibration_dialog_open: bool,
    warmup_s: float = _WARMUP_S,
    cooldown_s: float = _COOLDOWN_S,
    grace_s: float = _GRACE_S,
    output_age_threshold_ms: int = _OUTPUT_CB_AGE_MS,
    input_age_threshold_ms: int = _INPUT_CB_FRESH_MS,
):
    """Functional form of the callback-stall detector: maps the previous
    armed-at value to ``(next_armed_at, should_recover)``. Kept as a pure
    function for parity with the reference's API surface."""
    timer = _StallTimer()
    timer.armed_at = stall_started_at

    gated = (
        calibration_dialog_open
        or processing_started_at is None
        or now - processing_started_at < warmup_s
        or now - last_recovery_at < cooldown_s
    )
    suspicious = (
        output_cb_age_ms > output_age_threshold_ms
        and input_cb_age_ms < input_age_threshold_ms
    )
    if gated or not suspicious:
        return None, False
    fired = timer.advance(now, grace_s)
    return timer.armed_at, fired


class StreamRecoveryManager:
    """UI-free recovery heuristics state. Field names are part of the
    public surface (the reference exposes the armed-at timestamps)."""

    __slots__ = (
        "_output_timer",
        "_callback_timer",
        "_input_timer",
        "last_output_recovery_at",
        "processing_started_at",
    )

    def __init__(self):
        self._output_timer = _StallTimer()
        self._callback_timer = _StallTimer()
        self._input_timer = _StallTimer()
        self.last_output_recovery_at = 0.0
        self.processing_started_at = None

    # armed-at timestamps, exposed under the reference's field names
    @property
    def output_stall_started_at(self):
        return self._output_timer.armed_at

    @property
    def output_callback_stall_started_at(self):
        return self._callback_timer.armed_at

    @property
    def input_callback_stall_started_at(self):
        return self._input_timer.armed_at

    def _disarm_all(self) -> None:
        for timer in (self._output_timer, self._callback_timer,
                      self._input_timer):
            timer.disarm()

    def mark_processing_started(self, now=None) -> None:
        self.processing_started_at = time.monotonic() if now is None else now
        self._disarm_all()

    def mark_processing_stopped(self) -> None:
        self.processing_started_at = None
        self._disarm_all()

    def _in_warmup(self, now: float, warmup_s: float) -> bool:
        return now - self.processing_started_at < warmup_s

    def _in_cooldown(self, now: float, cooldown_s: float) -> bool:
        return now - self.last_output_recovery_at < cooldown_s

    def _fire(self, now: float) -> bool:
        self.last_output_recovery_at = now
        return True

    def maybe_recover_input_stall(
        self,
        *,
        input_cb_age_ms: int,
        calibration_dialog_open: bool,
        now=None,
        warmup_s: float = _WARMUP_S,
        cooldown_s: float = _COOLDOWN_S,
        grace_s: float = _GRACE_S,
        input_age_threshold_ms: int = _INPUT_CB_STALL_MS,
    ) -> bool:
        """Input heartbeat watch: a source that blocks or dies without an
        error surfaces here. Warmup/cooldown pause without disarming."""
        current = time.monotonic() if now is None else now
        if calibration_dialog_open or self.processing_started_at is None:
            self._input_timer.disarm()
            return False
        if self._in_warmup(current, warmup_s):
            return False
        if self._in_cooldown(current, cooldown_s):
            return False
        if input_cb_age_ms <= input_age_threshold_ms:
            self._input_timer.disarm()
            return False
        if self._input_timer.advance(current, grace_s):
            return self._fire(current)
        return False

    def maybe_recover_output_stall(
        self,
        *,
        input_rms: float,
        output_rms: float,
        output_buf: int,
        calibration_dialog_open: bool,
        now=None,
        cooldown_s: float = _COOLDOWN_S,
        grace_s: float = _GRACE_S,
    ) -> bool:
        """Live input + silent output + swollen buffer, sustained. Any
        failed gate disarms (no warmup gate on this detector)."""
        current = time.monotonic() if now is None else now
        suspicious = (
            input_rms > _LIVE_INPUT_RMS_DB
            and output_rms < _SILENT_OUTPUT_RMS_DB
            and output_buf > _SWOLLEN_OUTPUT_BUF
        )
        if (calibration_dialog_open
                or self._in_cooldown(current, cooldown_s)
                or not suspicious):
            self._output_timer.disarm()
            return False
        if self._output_timer.advance(current, grace_s):
            return self._fire(current)
        return False

    def maybe_recover_callback_stall(
        self,
        *,
        input_cb_age_ms: int,
        output_cb_age_ms: int,
        calibration_dialog_open: bool,
        now=None,
    ) -> bool:
        """Output callback stopped while input stays fresh. Any failed
        gate disarms."""
        current = time.monotonic() if now is None else now
        armed, should_recover = update_callback_stall_state(
            stall_started_at=self._callback_timer.armed_at,
            now=current,
            input_cb_age_ms=input_cb_age_ms,
            output_cb_age_ms=output_cb_age_ms,
            processing_started_at=self.processing_started_at,
            last_recovery_at=self.last_output_recovery_at,
            calibration_dialog_open=calibration_dialog_open,
        )
        self._callback_timer.armed_at = armed
        if should_recover:
            return self._fire(current)
        return False

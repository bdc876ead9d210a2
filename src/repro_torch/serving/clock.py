"""Injectable wall clock for the serving stack (copy of
``repro.serving.clock``): every serving timestamp reads through a clock
object, so tests can drive time with ``ManualClock``.  This module is the
one place serving code calls ``time.time``."""
from __future__ import annotations

import time


class SystemClock:
    """Real wall clock."""

    def now(self) -> float:
        return time.time()


class ManualClock:
    """Deterministic test clock: advances only when told to."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot rewind the clock (dt={dt})")
        self._now += dt
        return self._now


SYSTEM_CLOCK = SystemClock()

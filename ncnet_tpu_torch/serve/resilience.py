"""Overload degradation for the serving engine (the hysteresis controller of
``ncnet_tpu/serve/resilience.py``). Deadlines, shedding, the quality ladder
and the watchdog are not ported yet (ROADMAP A15)."""


class HysteresisController:
    """Queue-pressure -> degraded-mode controller with hysteresis.

    ``update(pressure)`` is called by the engine's dispatch thread (every
    loop iteration, so it keeps observing while idle and can flip BACK
    when pressure clears) and returns the current mode. ``pressure`` is
    the engine's queued-work fraction (queued requests / queue limit).

    Flip up: ``pressure >= high`` for ``up_count`` consecutive updates.
    Flip down: ``pressure <= low`` for ``down_count`` consecutive
    updates. Readings in the dead band (low, high) reset both streaks —
    mid-band noise keeps the current mode, which is the point of the
    hysteresis.
    """

    def __init__(self, high=0.75, low=0.25, up_count=2, down_count=4):
        if not low < high:
            raise ValueError(
                f"hysteresis needs low < high, got low={low} high={high}"
            )
        if up_count < 1 or down_count < 1:
            raise ValueError("up_count and down_count must be >= 1")
        self.high = high
        self.low = low
        self.up_count = up_count
        self.down_count = down_count
        self.degraded = False
        self.flips = 0
        self.last_pressure = 0.0
        self._above = 0
        self._below = 0

    def update(self, pressure):
        p = float(pressure)
        self.last_pressure = p
        if p >= self.high:
            self._above += 1
            self._below = 0
        elif p <= self.low:
            self._below += 1
            self._above = 0
        else:
            self._above = 0
            self._below = 0
        if not self.degraded and self._above >= self.up_count:
            self.degraded = True
            self.flips += 1
            self._above = 0
        elif self.degraded and self._below >= self.down_count:
            self.degraded = False
            self.flips += 1
            self._below = 0
        return self.degraded

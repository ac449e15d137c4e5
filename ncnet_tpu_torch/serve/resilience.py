"""Overload degradation for the serving engine: the two-mode hysteresis
controller and the multi-rung quality ladder of
``ncnet_tpu/serve/resilience.py``. Deadlines, shedding and the watchdog
are not ported yet (ROADMAP A15)."""


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


class QualityLadder:
    """Queue-pressure -> quality-rung controller (multi-level hysteresis).

    `HysteresisController` over an ordered ladder of program variants,
    richest first, e.g. ``("refined", "standard", "degraded")`` (the serve
    CLI's with ``--refine`` and ``--degrade``). ``update(pressure)``:
    sustained high pressure steps ONE rung toward cheaper per flip,
    sustained low pressure one rung back toward richer, and dead-band
    readings reset both streaks, so a spike cannot leap from refined to
    degraded and a recovering queue re-earns each rung one flip at a
    time. Each rung must name a program the engine warmed ("standard"
    plus any of "refined" / "degraded"); the engine clamps a rung it
    cannot serve to "standard".
    """

    def __init__(self, rungs=("refined", "standard", "degraded"),
                 start="standard", high=0.75, low=0.25, up_count=2,
                 down_count=4):
        rungs = tuple(rungs)
        if len(rungs) < 2:
            raise ValueError(f"a ladder needs >= 2 rungs, got {rungs!r}")
        if len(set(rungs)) != len(rungs):
            raise ValueError(f"duplicate rungs: {rungs!r}")
        if start not in rungs:
            raise ValueError(f"start rung {start!r} not in {rungs!r}")
        if not low < high:
            raise ValueError(
                f"hysteresis needs low < high, got low={low} high={high}"
            )
        if up_count < 1 or down_count < 1:
            raise ValueError("up_count and down_count must be >= 1")
        self.rungs = rungs
        self.high = high
        self.low = low
        self.up_count = up_count
        self.down_count = down_count
        self.flips = 0
        self.last_pressure = 0.0
        self._above = 0
        self._below = 0
        self._i = rungs.index(start)

    @property
    def variant(self):
        """The current rung's program variant."""
        return self.rungs[self._i]

    @property
    def rung(self):
        """The current position, 0 = richest."""
        return self._i

    @property
    def degraded(self):
        # named-rung semantics: a ("refined", "standard") ladder is never
        # degraded, its cheapest rung is the standard program
        return self.variant == "degraded"

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
        if self._above >= self.up_count and self._i < len(self.rungs) - 1:
            self._i += 1
            self.flips += 1
            self._above = 0
        elif self._below >= self.down_count and self._i > 0:
            self._i -= 1
            self.flips += 1
            self._below = 0
        return self.variant

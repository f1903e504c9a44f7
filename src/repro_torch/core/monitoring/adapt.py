"""Adaptive optimization (paper §3.5.2): a feedback loop that tunes control
parameters from realized performance.

The paper: "automatically adjusts system parameters to maintain optimal
performance under varying conditions".  Concretely tuned here:

  * forecast horizon (ticks ahead the scaler provisions for) — longer when
    adaptation keeps arriving late (SLO violations after load rises),
    shorter when utilization chronically undershoots;
  * target-utilization band — widened when the workload is stable, narrowed
    (more headroom) when anomalies are frequent;
  * scale-down cooldown — lengthened when flapping is detected (scale-down
    promptly followed by scale-up).

One-factor-at-a-time hill-climbing with hysteresis: each knob moves one step
per evaluation window and only if the composite objective (paper's reward)
improved the previous time that knob moved in that direction.

A numpy copy of ``repro.core.monitoring.adapt``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.scaling.scaler import ScalingConstraints


@dataclasses.dataclass
class AdaptState:
    horizon: int = 3
    util_lo: float = 0.55
    util_hi: float = 0.85
    cooldown: int = 3


class AdaptiveOptimizer:
    def __init__(self, *, eval_window: int = 48):
        self.state = AdaptState()
        self.window = eval_window
        self._records: list[dict] = []
        self._last_obj: float | None = None
        self._knobs = ("horizon", "cooldown", "util_hi", "util_lo")
        self._knob_idx = 0
        self._last_dir = {k: +1 for k in self._knobs}

    def push(self, record: dict, *, flapped: bool = False,
             violations: int = 0, cost: float = 0.0):
        self._records.append({**record, "flapped": float(flapped),
                              "violations": float(violations), "cost": cost})

    def _objective(self, recs) -> float:
        util = np.mean([r.get("flop_util", 0.0) for r in recs])
        viol = np.mean([r["violations"] for r in recs])
        cost = np.mean([r["cost"] for r in recs])
        flap = np.mean([r["flapped"] for r in recs])
        return float(util - 4.0 * viol - 0.2 * cost - 0.5 * flap)

    def maybe_adapt(self) -> AdaptState | None:
        """Every eval_window records: evaluate, move one knob."""
        if len(self._records) < self.window:
            return None
        recs, self._records = self._records[:self.window], \
            self._records[self.window:]
        obj = self._objective(recs)
        knob = self._knobs[self._knob_idx]
        self._knob_idx = (self._knob_idx + 1) % len(self._knobs)
        direction = self._last_dir[knob]
        if self._last_obj is not None and obj < self._last_obj:
            direction = -direction            # last move hurt: reverse
        self._last_dir[knob] = direction
        s = self.state
        if knob == "horizon":
            s.horizon = int(np.clip(s.horizon + direction, 1, 12))
        elif knob == "cooldown":
            s.cooldown = int(np.clip(s.cooldown + direction, 1, 12))
        elif knob == "util_hi":
            s.util_hi = float(np.clip(s.util_hi + 0.05 * direction, 0.6, 0.95))
        else:
            # the consolidation floor: live since the optimizer's key ranks
            # feasible under-utilized fleets behind in-band ones — the knob
            # stays strictly below util_hi so the band never inverts
            s.util_lo = float(np.clip(s.util_lo + 0.05 * direction,
                                      0.3, s.util_hi - 0.1))
        self._last_obj = obj
        return s

    def constraints(self, base: ScalingConstraints) -> ScalingConstraints:
        import dataclasses as dc
        return dc.replace(base, cooldown_ticks=self.state.cooldown,
                          target_util=(self.state.util_lo, self.state.util_hi))

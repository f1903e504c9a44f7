"""Statistical anomaly detection + trend analysis (paper §3.5.1 pipeline
stages 2-3): EWMA-residual z-scores with a MAD scale (robust to the very
outliers being hunted), plus rolling linear trend estimation used by the
forecaster and the adaptive optimizer.

A numpy copy of ``repro.core.monitoring.anomaly``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Anomaly:
    tick: int
    metric: str
    value: float
    zscore: float
    kind: str          # "spike" | "drop" | "level_shift"


class AnomalyDetector:
    def __init__(self, *, alpha: float = 0.2, z_threshold: float = 4.0,
                 min_history: int = 16):
        self.alpha = alpha
        self.z = z_threshold
        self.min_history = min_history
        self.level: dict[str, float] = {}
        self.resid: dict[str, list[float]] = {}
        self.n: dict[str, int] = {}

    def update(self, tick: int, metrics: dict) -> list[Anomaly]:
        out = []
        for k, v in metrics.items():
            if not isinstance(v, (int, float)):
                continue
            lvl = self.level.get(k, v)
            resid = v - lvl
            hist = self.resid.setdefault(k, [])
            n = self.n.get(k, 0)
            v_eff = v
            if n >= self.min_history:
                mad = np.median(np.abs(np.asarray(hist))) * 1.4826 + 1e-9
                z = resid / mad
                if abs(z) > self.z:
                    out.append(Anomaly(tick, k, float(v), float(z),
                                       "spike" if z > 0 else "drop"))
                    # a flagged outlier must not contaminate the baseline:
                    # clamp its influence on the level / residual history to
                    # the detection threshold (otherwise one spike drags the
                    # EWMA up and every following normal tick fires as "drop")
                    v_eff = lvl + float(np.sign(resid)) * self.z * mad
            hist.append(float(v_eff - lvl))
            if len(hist) > 256:
                del hist[:128]
            self.level[k] = (1 - self.alpha) * lvl + self.alpha * v_eff
            self.n[k] = n + 1
        return out


def trend(values: np.ndarray) -> float:
    """Robust slope (Theil–Sen on a decimated window) per tick."""
    v = np.asarray(values, float)
    if len(v) < 4:
        return 0.0
    idx = np.arange(len(v))
    slopes = []
    step = max(len(v) // 16, 1)
    for i in range(0, len(v) - step, step):
        for j in range(i + step, len(v), step):
            slopes.append((v[j] - v[i]) / (j - i))
    return float(np.median(slopes)) if slopes else 0.0

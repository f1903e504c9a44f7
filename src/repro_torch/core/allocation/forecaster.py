"""Workload forecasting (paper §3.3.2): statistics + learning combined.

The paper: "The prediction model employs a combination of statistical
analysis and machine learning techniques".  Components:

  * seasonal-naive — daily and weekly profile tables (the paper's §4.2.2
    "daily and weekly workload patterns"), updated online with EWMA;
  * local trend — robust linear fit over the recent window;
  * EWMA level — fast-reacting base level;
  * learned residual — a small ridge-regression on (hour-of-day, day-of-week,
    recent lags) fitted online, capturing what the statistical parts miss.

Predictions are blended with inverse-error weights learned from realized
one-step errors, so whichever component tracks the current regime best
dominates — this is the "continuously refined" behaviour §2.2 describes.

A numpy copy of ``repro.core.allocation.forecaster``.
"""
from __future__ import annotations

import numpy as np


class WorkloadForecaster:
    def __init__(self, *, ticks_per_day: int = 288, alpha: float = 0.3,
                 trend_window: int = 24, n_lags: int = 6):
        self.tpd = ticks_per_day
        self.alpha = alpha
        self.trend_window = trend_window
        self.n_lags = n_lags
        self.daily = np.zeros(ticks_per_day)
        self.daily_n = np.zeros(ticks_per_day)
        self.weekly = np.zeros(7)
        self.weekly_n = np.zeros(7)
        self.level = 0.0
        self.hist: list[float] = []
        # ridge residual model on (sin/cos tod, dow one-hot-ish, lags)
        d = 4 + n_lags
        self._A = np.eye(d) * 1.0
        self._b = np.zeros(d)
        self._comp_err = np.ones(4)     # ewma |err| per component
        self.t = 0

    # ------------------------------------------------------------- helpers

    def _phase(self, t):
        tod = t % self.tpd
        dow = (t // self.tpd) % 7
        return tod, dow

    def _feat(self, t):
        tod, dow = self._phase(t)
        ang = 2 * np.pi * tod / self.tpd
        lags = [self.hist[-k] if len(self.hist) >= k else self.level
                for k in range(1, self.n_lags + 1)]
        return np.array([np.sin(ang), np.cos(ang), dow / 6.0, 1.0] + lags)

    def _components(self, t_next) -> np.ndarray:
        tod, dow = self._phase(t_next)
        seas_d = self.daily[tod] if self.daily_n[tod] > 0 else self.level
        seas_w = (seas_d * (self.weekly[dow] /
                            max(np.mean(self.weekly[self.weekly_n > 0]), 1e-9))
                  if self.weekly_n[dow] > 0 else seas_d)
        if len(self.hist) >= 3:
            w = min(self.trend_window, len(self.hist))
            y = np.array(self.hist[-w:])
            x = np.arange(w)
            slope = (np.mean((x - x.mean()) * (y - y.mean()))
                     / (np.var(x) + 1e-9))
            trend = y[-1] + slope
        else:
            trend = self.level
        ridge = float(self._feat(t_next) @ np.linalg.solve(self._A, self._b))
        return np.array([seas_d, seas_w, trend, ridge])

    # ------------------------------------------------------------- API

    def update(self, value: float):
        """Observe this tick's realized load."""
        t = self.t
        # score the previous prediction's components
        comps = self._components(t)
        self._comp_err = 0.95 * self._comp_err + 0.05 * np.abs(comps - value)
        tod, dow = self._phase(t)
        # first-observation seeding is gated on the SEEN COUNTS, never on
        # truthiness: a legitimately observed 0.0 load makes the stored EWMA
        # 0.0, and the next value must DECAY toward it, not reset the profile
        prev_d = self.daily[tod] if self.daily_n[tod] > 0 else value
        self.daily[tod] = self.alpha * value + (1 - self.alpha) * prev_d
        self.daily_n[tod] += 1
        prev_w = self.weekly[dow] if self.weekly_n[dow] > 0 else value
        self.weekly[dow] = self.alpha * value + (1 - self.alpha) * prev_w
        self.weekly_n[dow] += 1
        prev_l = self.level if self.t > 0 else value
        self.level = self.alpha * value + (1 - self.alpha) * prev_l
        f = self._feat(t)
        self._A += np.outer(f, f)
        self._b += f * value
        self.hist.append(float(value))
        if len(self.hist) > 8 * self.tpd:
            del self.hist[:self.tpd]
        self.t += 1

    def predict(self, horizon: int = 1) -> float:
        """Forecast the load ``horizon`` ticks ahead (inverse-error blend)."""
        comps = self._components(self.t + horizon - 1)
        w = 1.0 / (self._comp_err + 1e-6)
        w /= w.sum()
        return float(max(comps @ w, 0.0))

    def predict_peak(self, horizon: int) -> float:
        """Max forecast over the next ``horizon`` ticks (proactive scaling
        targets the peak, not the mean)."""
        return max(self.predict(h) for h in range(1, horizon + 1))

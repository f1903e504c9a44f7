"""Workload-trace generation (paper §4.2.2: daily and weekly patterns,
sudden spikes, regional offsets).

The paper's production traces are proprietary; these synthetic traces carry
the properties the paper names — diurnal cycle, weekly seasonality, heavy-
tailed noise, flash spikes — with magnitudes calibrated so the traditional
baseline reproduces the paper's starting point (≈58% utilization at 250 ms,
§4.1.1).  Regions shift the diurnal phase (paper §4.1.2 multi-region).

A numpy copy of ``repro.sim.workload``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

REGIONS = ("na", "eu", "apac", "sa", "au")
REGION_PHASE = {"na": 0.0, "eu": -6.0, "apac": -13.0, "sa": 1.0, "au": -15.0}
REGION_SCALE = {"na": 1.0, "eu": 0.8, "apac": 0.9, "sa": 0.35, "au": 0.25}


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    base_rps: float = 120.0
    diurnal_amp: float = 0.55        # fraction of base
    weekly_amp: float = 0.15
    noise_cv: float = 0.08
    spike_prob: float = 0.004        # per tick
    spike_mult: (float, float) = (1.8, 3.5)
    spike_len_ticks: (int, int) = (3, 12)
    ticks_per_day: int = 288         # 5-min ticks
    region: str = "na"
    seed: int = 0


def generate_trace(cfg: TraceConfig, n_ticks: int) -> np.ndarray:
    # zlib.crc32, NOT hash(): python's str hash is salted per process, which
    # would make traces irreproducible across runs
    import zlib
    rng = np.random.default_rng(cfg.seed
                                + zlib.crc32(cfg.region.encode()) % 1000)
    t = np.arange(n_ticks)
    hours = (t / cfg.ticks_per_day * 24.0 + REGION_PHASE[cfg.region]) % 24.0
    day = t // cfg.ticks_per_day % 7
    # diurnal: business-hours hump, low at night
    diurnal = 1.0 + cfg.diurnal_amp * np.sin((hours - 6.0) / 24.0 * 2 * np.pi)
    weekly = 1.0 - cfg.weekly_amp * ((day >= 5).astype(float))
    rps = cfg.base_rps * REGION_SCALE[cfg.region] * diurnal * weekly
    rps *= rng.lognormal(0.0, cfg.noise_cv, size=n_ticks)
    # flash spikes
    i = 0
    while i < n_ticks:
        if rng.random() < cfg.spike_prob:
            ln = rng.integers(*cfg.spike_len_ticks)
            mult = rng.uniform(*cfg.spike_mult)
            ramp = np.linspace(1.0, mult, max(ln // 3, 1))
            prof = np.concatenate([ramp, np.full(ln - 2 * len(ramp), mult),
                                   ramp[::-1]]) if ln >= 2 * len(ramp) \
                else np.full(ln, mult)
            end = min(i + len(prof), n_ticks)
            rps[i:end] *= prof[:end - i]
            i = end
        i += 1
    return np.maximum(rps, 1.0)

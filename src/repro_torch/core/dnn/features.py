"""Feature engineering for the multi-stream DNN (paper §3.2.2).

Raw monitoring records (dicts of scalars per tick) are turned into the three
model streams: sliding windows with running-statistics normalization for the
temporal streams, and a static vector (normalized against catalog ranges) for
deployment parameters.

A numpy copy of ``repro.core.dnn.features``.
"""
from __future__ import annotations

import numpy as np

RESOURCE_KEYS = ("flop_util", "hbm_util", "ici_util", "mem_frac",
                 "queue_depth", "replicas_frac",
                 # paged-pool cache efficiency (0 on dense fleets): shared-
                 # prefix admissions and the prompt tokens they saved
                 "prefix_hits", "tokens_shared",
                 # capacity volatility: spot replicas reclaimed this tick
                 # (the collector's fleet event channel; 0 on homogeneous
                 # fleets) — the model sees supply disappearing, not just
                 # the latency it causes
                 "preemptions")
PERF_KEYS = ("latency_p50", "latency_p95", "throughput", "error_rate",
             "rps",
             # speculative-decode acceptance this window (0 with spec off)
             "accept_rate",
             # per-tier SLO pressure (0 on single-tier fleets): the DNN
             # sees interactive-lane risk separately from batch queueing
             "latency_p95_interactive", "latency_p95_batch",
             # placement pressure this tick (fleet event channels, 0 when
             # unprofiled/region-less): interactive work forced onto
             # volatile capacity, and forced out of its origin region
             "tier_spills", "region_spills")


class RunningNorm:
    """Streaming mean/std (Welford) used to normalize each metric channel."""

    def __init__(self, n: int):
        self.n = 0
        self.mean = np.zeros(n)
        self.m2 = np.ones(n)

    def update(self, x: np.ndarray):
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    def normalize(self, x: np.ndarray) -> np.ndarray:
        std = np.sqrt(self.m2 / max(self.n, 1)) + 1e-6
        return (x - self.mean) / std


class StreamBuilder:
    """Maintains sliding windows over monitoring ticks → DNN input streams."""

    def __init__(self, window: int = 32):
        self.window = window
        self.res_hist: list[np.ndarray] = []
        self.perf_hist: list[np.ndarray] = []
        self.res_norm = RunningNorm(len(RESOURCE_KEYS))
        self.perf_norm = RunningNorm(len(PERF_KEYS))

    def push(self, record: dict):
        r = np.array([float(record.get(k, 0.0)) for k in RESOURCE_KEYS])
        p = np.array([float(record.get(k, 0.0)) for k in PERF_KEYS])
        self.res_norm.update(r)
        self.perf_norm.update(p)
        self.res_hist.append(r)
        self.perf_hist.append(p)
        if len(self.res_hist) > 4 * self.window:
            del self.res_hist[:-2 * self.window]
            del self.perf_hist[:-2 * self.window]

    def streams(self, deploy_vec: np.ndarray):
        """→ {"resource": (1,T,F_r), "perf": (1,T,F_p), "deploy": (1,F_d)}."""
        T = self.window
        res = np.stack(self.res_hist[-T:]) if self.res_hist else np.zeros((1, len(RESOURCE_KEYS)))
        perf = np.stack(self.perf_hist[-T:]) if self.perf_hist else np.zeros((1, len(PERF_KEYS)))
        res = self.res_norm.normalize(res)
        perf = self.perf_norm.normalize(perf)
        if len(res) < T:    # left-pad with the earliest row
            res = np.concatenate([np.repeat(res[:1], T - len(res), 0), res])
            perf = np.concatenate([np.repeat(perf[:1], T - len(perf), 0), perf])
        return {
            "resource": res[None].astype(np.float32),
            "perf": perf[None].astype(np.float32),
            "deploy": deploy_vec[None].astype(np.float32),
        }


def deploy_vector(*, model_params_b: float, family: str, mesh_model: int,
                  mesh_data: int, region_idx: int, slo_ms: float,
                  cost_weight: float, n_deploy_features: int = 12) -> np.ndarray:
    """Static deployment-parameter featurization (normalized)."""
    families = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
    v = np.zeros(n_deploy_features, np.float32)
    v[0] = np.log10(max(model_params_b, 0.01)) / 2.0
    v[1] = mesh_model / 64.0
    v[2] = mesh_data / 64.0
    v[3] = region_idx / 8.0
    v[4] = slo_ms / 1000.0
    v[5] = cost_weight
    if family in families:
        v[6 + families.index(family)] = 1.0
    return v

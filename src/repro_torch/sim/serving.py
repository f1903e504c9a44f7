"""The request shape shared by the control plane's queueing model and the
data plane (a copy of ``repro.sim.serving.WorkloadSpec``; the queueing
model itself is not ported yet)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Request shape: serving/workload.py builds engine Requests from it."""
    prompt_len: int = 1024
    gen_len: int = 128
    timeout_factor: float = 4.0      # × SLO before a request is dropped

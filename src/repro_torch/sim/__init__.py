"""The simulator's numpy pieces (``repro.sim``): workload traces, the
multi-cloud cluster's cost and provisioning model, the "traditional MLOps"
baselines, and the request shape shared with the data plane.

Not ported yet: the queueing serving model (``ServiceProfile``,
``ServingModel``, ``mmc_wait_s``) and ``RooflineDB``.  Both read the
reference's compiled dry-run cells and its accelerator's peak constants;
the port needs its own FLOP and byte counts first.
"""
from repro_torch.sim.baseline import (
    StaticAllocator, ThresholdAutoscaler, TRADITIONAL_STRATEGY,
    traditional_deploy_seconds,
)
from repro_torch.sim.cluster import Cluster, PROVIDERS, REGION_COST_MULT
from repro_torch.sim.serving import WorkloadSpec
from repro_torch.sim.workload import REGIONS, TraceConfig, generate_trace

__all__ = [
    "Cluster", "PROVIDERS", "REGION_COST_MULT", "WorkloadSpec",
    "REGIONS", "TraceConfig", "generate_trace",
    "StaticAllocator", "ThresholdAutoscaler", "TRADITIONAL_STRATEGY",
    "traditional_deploy_seconds",
]

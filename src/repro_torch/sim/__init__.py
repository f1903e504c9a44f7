"""The simulator (``repro.sim``), grounded in the port's dry-run cells:
workload traces (workload.py) drive a queueing serving model (serving.py)
whose per-replica throughput and latency come from one card's dry-run
cells (roofline_db.py, on H100 constants); the cluster model (cluster.py)
accounts cost and provisioning; baseline.py implements the paper's
"traditional MLOps" comparison points.
"""
from repro_torch.sim.baseline import (
    StaticAllocator, ThresholdAutoscaler, TRADITIONAL_STRATEGY,
    traditional_deploy_seconds,
)
from repro_torch.sim.cluster import Cluster, PROVIDERS, REGION_COST_MULT
from repro_torch.sim.roofline_db import (
    HBM_BW, ICI_BW, PEAK_FLOPS, RooflineDB, RooflineTerms,
)
from repro_torch.sim.serving import (
    ServiceProfile, ServingModel, WorkloadSpec, mmc_wait_s,
)
from repro_torch.sim.workload import REGIONS, TraceConfig, generate_trace

__all__ = [
    "Cluster", "PROVIDERS", "REGION_COST_MULT",
    "RooflineDB", "RooflineTerms", "PEAK_FLOPS", "HBM_BW", "ICI_BW",
    "ServiceProfile", "ServingModel", "WorkloadSpec", "mmc_wait_s",
    "REGIONS", "TraceConfig", "generate_trace",
    "StaticAllocator", "ThresholdAutoscaler", "TRADITIONAL_STRATEGY",
    "traditional_deploy_seconds",
]

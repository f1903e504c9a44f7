"""Continuous-batching serving data plane (the in-process replica of
``repro.serving``): sampling, scheduler, dense and paged slot pools, the
prompt-lookup draft, engine and the synthetic workload.  The replica
fabric, router and control-plane hooks are not ported yet."""
from repro_torch.serving.engine import EngineCore, ServingEngine
from repro_torch.serving.sampling import SamplingParams, sample_token
from repro_torch.serving.scheduler import FCFSScheduler, Request, TIERS
from repro_torch.serving.slots import (
    PagedSlotPool, SlotPool, make_pool, paged_cache_spec, write_slot,
)
from repro_torch.serving.workload import (
    poisson_arrival_times, synthetic_requests,
)

__all__ = [
    "EngineCore", "ServingEngine", "SamplingParams", "sample_token",
    "FCFSScheduler", "Request", "TIERS", "PagedSlotPool", "SlotPool",
    "make_pool", "paged_cache_spec", "write_slot", "poisson_arrival_times",
    "synthetic_requests",
]

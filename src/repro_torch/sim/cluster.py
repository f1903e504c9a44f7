"""Multi-cloud cluster model: providers, regions, cost, provisioning delays.

Mirrors the paper's evaluation surface (AWS / GCP / Azure × five regions).
The scaling unit is an accelerator replica (chips_per_replica devices).
Costs are $/device-hour with provider/region multipliers; provisioning is a
lognormal delay during which the replica bills but serves nothing — this is
what makes *reactive* scaling expensive and *predictive* scaling win (the
paper's core claim).

A numpy copy of ``repro.sim.cluster``: its prices and delays are simulation
inputs, copied for parity, not quotes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PROVIDERS = {
    # $/device-hour base, provisioning median (s), provisioning sigma
    "aws":   {"cost": 1.35, "prov_med_s": 210.0, "prov_sigma": 0.45},
    "gcp":   {"cost": 1.20, "prov_med_s": 150.0, "prov_sigma": 0.35},
    "azure": {"cost": 1.45, "prov_med_s": 260.0, "prov_sigma": 0.55},
}

REGION_COST_MULT = {"na": 1.00, "eu": 1.12, "apac": 1.18, "sa": 1.25,
                    "au": 1.30}


@dataclasses.dataclass
class Replica:
    id: int
    ready_at_tick: float          # provisioning completes
    provider: str
    region: str


class Cluster:
    def __init__(self, *, provider: str = "gcp", region: str = "na",
                 chips_per_replica: int = 16, tick_s: float = 10.0,
                 seed: int = 0):
        self.provider = provider
        self.region = region
        self.chips = chips_per_replica
        self.tick_s = tick_s
        self.rng = np.random.default_rng(seed)
        self.replicas: list[Replica] = []
        self._next_id = 0
        self.tick = 0
        self.spend_usd = 0.0

    # ------------------------------------------------------------- scaling

    def scale_to(self, target: int):
        target = max(target, 0)
        while len(self.replicas) > target:
            # cancel in-flight provisioning first; drain warm replicas only
            # when no cold ones remain (never swap warm capacity for cold)
            idx = len(self.replicas) - 1
            for i in range(len(self.replicas) - 1, -1, -1):
                if self.replicas[i].ready_at_tick > self.tick:
                    idx = i
                    break
            self.replicas.pop(idx)
        p = PROVIDERS[self.provider]
        while len(self.replicas) < target:
            delay_s = self.rng.lognormal(np.log(p["prov_med_s"]),
                                         p["prov_sigma"])
            self.replicas.append(Replica(
                id=self._next_id, provider=self.provider, region=self.region,
                ready_at_tick=self.tick + delay_s / self.tick_s))
            self._next_id += 1

    def ready_replicas(self) -> int:
        return sum(1 for r in self.replicas if r.ready_at_tick <= self.tick)

    def total_replicas(self) -> int:
        return len(self.replicas)

    def replace(self, replica_idx: int):
        """Straggler mitigation: drain + re-provision one replica."""
        if 0 <= replica_idx < len(self.replicas):
            p = PROVIDERS[self.provider]
            delay_s = self.rng.lognormal(np.log(p["prov_med_s"]),
                                         p["prov_sigma"])
            self.replicas[replica_idx] = Replica(
                id=self._next_id, provider=self.provider, region=self.region,
                ready_at_tick=self.tick + delay_s / self.tick_s)
            self._next_id += 1

    # ------------------------------------------------------------- time/cost

    def cost_per_tick(self) -> float:
        rate = (PROVIDERS[self.provider]["cost"]
                * REGION_COST_MULT[self.region])
        return len(self.replicas) * self.chips * rate * self.tick_s / 3600.0

    def advance(self, *, fail_prob: float = 0.0):
        """One tick: accrue cost; optionally fail replicas (node failures)."""
        self.spend_usd += self.cost_per_tick()
        self.tick += 1
        if fail_prob > 0:
            for i, r in enumerate(self.replicas):
                if (r.ready_at_tick <= self.tick
                        and self.rng.random() < fail_prob):
                    self.replace(i)

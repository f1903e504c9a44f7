"""Replica profiles: what makes one replica NOT interchangeable with another.

The fleet's capacity is heterogeneous on three axes the router must see:

* **economics** — an on-demand replica and a preemptible (spot) one differ
  in cost per tick, and the provider may reclaim the spot one without
  notice mid-decode; under a ``SpotMarket`` the spot price is a *process*,
  not a constant — mean-reverting with occasional demand spikes;
* **capability** — replicas on different hardware serve different relative
  tokens/s, so "least loaded" is wrong unless load is normalized by speed;
* **geography** — replicas live in regions, and reaching a remote region
  costs a round trip.  The plan's RTT matrix is what the router injects
  into the replica fabric as deterministic transport delay, and what makes
  region-aware placement measurable against region-blind.

``ReplicaProfile`` is the router's static prior for one replica: its cost
per tick, its relative speed (1.0 = the fleet baseline), whether the
capacity is volatile, and which region it lives in.  In simulation the
prior is seeded from the roofline DB's ``ServiceProfile``
(``ReplicaProfile.from_service``); live, the router refines the speed axis
from each replica's measured lifetime tokens/tick — the profile is a
prior, the measurement wins once there is enough of it.

``FleetPlan`` is the deployment shape the operator actually buys: the first
``reserved`` replica ids are on-demand (stable, expensive), every id past
them is preemptible (cheap, volatile); ``regions`` assigns each id a
geography (cycled, so a 2-region tuple stripes the fleet).  It doubles as
the planner's cost model — ``cost_of(n, tick)`` is what the profile-aware
ScalingOptimizer minimizes instead of a flat per-replica price, priced at
the market's spot rate for that tick when a ``market`` is attached.

A numpy copy of ``repro.serving.profiles``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Inter-region round-trip times (ms) between the sim's five regions
# (repro/sim/workload.py REGIONS).  Symmetric; same-region is free.  The
# numbers are representative public-cloud medians, not measurements — what
# matters for the benchmark is that cross-region >> one decode tick.
DEFAULT_RTT_MS = {
    ("na", "eu"): 90.0, ("na", "apac"): 150.0, ("na", "sa"): 120.0,
    ("na", "au"): 160.0, ("eu", "apac"): 200.0, ("eu", "sa"): 180.0,
    ("eu", "au"): 250.0, ("apac", "sa"): 280.0, ("apac", "au"): 110.0,
    ("sa", "au"): 300.0,
}


def rtt_between(a: str, b: str, matrix: dict | None = None) -> float:
    """RTT in ms between two region tags: 0 for same/unknown regions, the
    matrix entry (either key order) otherwise."""
    if not a or not b or a == b:
        return 0.0
    m = DEFAULT_RTT_MS if matrix is None else matrix
    return float(m.get((a, b)) or m.get((b, a)) or 0.0)


@dataclasses.dataclass(frozen=True)
class ReplicaProfile:
    """Static prior for one replica's economics, capability, geography."""
    cost_per_tick: float = 1.0
    # relative throughput vs the fleet baseline (2.0 = twice the tokens/s);
    # routing divides load by it, so a fast replica looks emptier
    speed: float = 1.0
    # volatile capacity: may be reclaimed without notice.  The router never
    # places interactive-tier work here and does not replace it on loss —
    # the scaler re-provisions when the forecast still needs the capacity
    preemptible: bool = False
    # geography: "" = region-less (the pre-region default — routing is
    # bit-identical to the legacy key).  When tagged, the router prefers
    # in-region capacity for interactive traffic (region_spills counts
    # forced cross-region placements)
    region: str = ""

    @classmethod
    def from_service(cls, service, baseline=None, *,
                     cost_per_tick: float = 1.0,
                     preemptible: bool = False,
                     region: str = "") -> "ReplicaProfile":
        """Seed a profile from a sim ServiceProfile (repro_torch.sim.serving):
        speed is the service's tokens/s relative to ``baseline`` (another
        ServiceProfile, default: itself → 1.0)."""
        base = baseline if baseline is not None else service
        return cls(cost_per_tick=cost_per_tick,
                   speed=service.relative_speed(base),
                   preemptible=preemptible, region=region)


@dataclasses.dataclass(frozen=True)
class SpotMarket:
    """A seeded spot-price process: mean-reverting walk around ``base``
    with occasional multiplicative demand spikes that decay over
    ``spike_ticks``.  ``price(tick)`` is deterministic in (seed, tick) —
    the path is extended lazily and cached, so query order never changes
    it — and never drops below ``floor`` (prices stay positive).

    This is the difference between a planner that buys spot at a catalog
    constant and one that faces a market: under a spike the marginal spot
    replica can briefly cost MORE than on-demand, and the optimizer should
    stop buying it."""
    seed: int = 0
    base: float = 0.35        # the level the walk reverts to
    sigma: float = 0.03       # per-tick gaussian noise
    revert: float = 0.25      # mean-reversion strength (0..1)
    spike_prob: float = 0.02  # per-tick chance a demand spike starts
    spike_mult: float = 3.5   # price multiple at a spike's peak
    spike_ticks: int = 6      # ticks a spike takes to decay
    floor: float = 0.05       # hard lower bound (prices stay positive)

    def __post_init__(self):
        # lazily-extended price path + walk state.  Mutable caches on a
        # frozen dataclass: the *parameters* are immutable identity, the
        # cache is pure memoization of a deterministic function of them.
        object.__setattr__(self, "_path",
                           [max(float(self.base), float(self.floor))])
        object.__setattr__(self, "_rng", np.random.default_rng(self.seed))
        object.__setattr__(self, "_spike_left", [0])

    def price(self, tick: int) -> float:
        """Spot price at ``tick`` (tick 0 = ``base``).  Extends the cached
        path sequentially, so any access order yields the same series."""
        tick = max(int(tick), 0)
        path, spike = self._path, self._spike_left
        while len(path) <= tick:
            p = path[-1]
            p = p + self.revert * (self.base - p) \
                + self.sigma * float(self._rng.normal())
            if float(self._rng.random()) < self.spike_prob:
                spike[0] = self.spike_ticks
            if spike[0] > 0:
                # a spike pins the price to a decaying multiple of base —
                # reversion resumes once it has burnt down
                frac = spike[0] / max(self.spike_ticks, 1)
                p = max(p, self.base * (1.0 + (self.spike_mult - 1.0) * frac))
                spike[0] -= 1
            path.append(max(float(p), float(self.floor)))
        return path[tick]

    def prices(self, ticks: int) -> list[float]:
        """The first ``ticks`` prices (extends the cache once)."""
        self.price(max(int(ticks) - 1, 0))
        return list(self._path[:max(int(ticks), 0)])


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """The capacity mix the operator buys: ``reserved`` on-demand replicas
    (ids 0..reserved-1), preemptible ones past that, each id assigned a
    region by cycling ``regions``.  Serves as the router's profile_fn AND
    the optimizer's marginal-cost model; with a ``market`` attached the
    spot leg of ``cost_of`` is priced per tick."""
    reserved: int = 1
    cost_on_demand: float = 1.0
    cost_preemptible: float = 0.35
    speed_on_demand: float = 1.0
    speed_preemptible: float = 1.0
    # geography: region per replica id, cycled — ("na","eu") stripes the
    # fleet na,eu,na,eu,…  () keeps the plan region-less (no RTT, routing
    # bit-identical to the legacy key)
    regions: tuple = ()
    # where the router / traffic origin sits; defaults to regions[0]
    home_region: str = ""
    # {(a,b): ms} RTT overrides; None = DEFAULT_RTT_MS
    rtt_ms: dict | None = None
    # spot-price process; None keeps cost_preemptible a constant
    market: SpotMarket | None = None

    def region_of(self, replica_id: int) -> str:
        if not self.regions:
            return ""
        return self.regions[int(replica_id) % len(self.regions)]

    @property
    def origin(self) -> str:
        """The region traffic originates from (router's vantage point)."""
        return self.home_region or (self.regions[0] if self.regions else "")

    def transport_ms_for(self, replica_id: int) -> float:
        """Deterministic RTT the fabric injects in front of this replica:
        the matrix entry between the traffic origin and the replica's
        region (0 in-region / region-less)."""
        return rtt_between(self.origin, self.region_of(replica_id),
                           self.rtt_ms)

    def spot_price(self, tick: int | None = None) -> float:
        """The spot rate: the market's price at ``tick`` when both exist,
        else the constant ``cost_preemptible`` (backward compatible)."""
        if self.market is None or tick is None:
            return self.cost_preemptible
        return self.market.price(tick)

    def price_of(self, replica_id: int, tick: int | None = None) -> float:
        """What one replica id costs per tick — reserved ids at the
        on-demand rate, spot ids at the (possibly time-varying) spot
        rate."""
        if replica_id < self.reserved:
            return self.cost_on_demand
        return self.spot_price(tick)

    def profile_for(self, replica_id: int) -> ReplicaProfile:
        if replica_id < self.reserved:
            return ReplicaProfile(cost_per_tick=self.cost_on_demand,
                                  speed=self.speed_on_demand,
                                  preemptible=False,
                                  region=self.region_of(replica_id))
        return ReplicaProfile(cost_per_tick=self.cost_preemptible,
                              speed=self.speed_preemptible,
                              preemptible=True,
                              region=self.region_of(replica_id))

    # FleetPlan IS callable as a router profile_fn
    __call__ = profile_for

    def cost_of(self, n: int, tick: int | None = None) -> float:
        """Cost per tick of running ``n`` replicas under this plan — the
        profile-aware ScalingOptimizer's cost term.  Scale-up past the
        reserved pool is priced at the SPOT rate — cheap volatile capacity
        is exactly what batch headroom should be bought with — and when a
        market is attached that rate is the market's price at ``tick``, so
        the planner stops buying spot into a price spike."""
        n = max(int(n), 0)
        on_demand = min(n, self.reserved)
        return (on_demand * self.cost_on_demand
                + (n - on_demand) * self.spot_price(tick))

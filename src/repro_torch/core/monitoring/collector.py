"""Distributed metric collection (paper §3.5.1).

MetricsCollector aggregates per-replica reports into temporally-aligned
fleet-level records: ring buffers per (replica, metric), tick-aligned
aggregation (mean / p50 / p95 / max), and staleness handling (a replica that
missed a tick contributes its last value, decayed — the paper's "data
consistency and temporal alignment").  Straggler detection lives here too:
per-replica latency EWMAs flagged against the fleet median.

A numpy copy of ``repro.core.monitoring.collector``.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np


@dataclasses.dataclass
class ReplicaReport:
    replica_id: int
    tick: int
    latency_ms_samples: list
    n_requests: int
    n_errors: int
    flop_util: float
    hbm_util: float
    ici_util: float
    mem_frac: float
    queue_depth: int
    # round-trip cost of reaching this replica (0 for in-process ones) —
    # the control plane's view of how remote the replica is.  Streamed
    # reports carry it so the scaler/selector can budget for it.
    transport_ms: float = 0.0
    # speculative decoding events this window: draft tokens proposed and
    # accepted (defaulted so report producers without speculation — older
    # workers, hand-built test reports — keep constructing cleanly)
    spec_proposed: int = 0
    spec_accepted: int = 0
    # the window's latency samples keyed by admission tier ("interactive" /
    # "batch") — the per-tier SLO channels aggregate from these; None from
    # report producers that predate tiers (single-tier fleets lose nothing)
    lat_tiers: dict | None = None


# router-level lifetime counters the collector turns into per-tick EVENT
# channels (delta vs the previous aggregate): spot reclaims, interactive
# work forced onto volatile capacity, interactive work forced out of its
# region.  These ride the fleet record into the DNN feature streams.
FLEET_EVENT_KEYS = ("preemptions", "tier_spills", "region_spills")


class MetricsCollector:
    def __init__(self, *, window: int = 512, straggler_factor: float = 1.8,
                 max_staleness: int = 8):
        self.window = window
        self.straggler_factor = straggler_factor
        # a replica silent for more than this many ticks leaves the fleet
        # aggregate entirely: decayed-toward-zero ghosts (retired replicas'
        # tombstones) must not keep diluting unweighted channels like
        # transport_ms / queue_depth for the rest of the run
        self.max_staleness = max_staleness
        self.reports: dict[int, list[ReplicaReport]] = defaultdict(list)
        self.fleet_records: list[dict] = []
        self._lat_ewma: dict[int, float] = {}
        self._errored: dict[int, int] = {}
        # per-replica watermark: report ticks whose EVENT channels have been
        # folded into an aggregate — each event is counted exactly once,
        # even when a report lands an aggregate tick late
        self._consumed: dict[int, int] = {}
        # fleet-level lifetime counters (observe_fleet) and the totals
        # already folded into an aggregate — same exactly-once contract as
        # the per-replica event watermark, but for router-side counters
        # that no single replica can report
        self._fleet_totals: dict[str, float] = {}
        self._fleet_consumed: dict[str, float] = {}

    def observe_fleet(self, counters: dict):
        """Publish router-level LIFETIME counters (monotonic totals —
        preemptions, tier_spills, region_spills).  The next ``aggregate``
        emits each as a per-tick event count: total minus what previous
        aggregates already consumed, never re-counting and never negative
        (a counter reset after a router swap just re-bases)."""
        for k in FLEET_EVENT_KEYS:
            if k in counters:
                self._fleet_totals[k] = float(counters[k])

    def submit(self, report: ReplicaReport):
        buf = self.reports[report.replica_id]
        buf.append(report)
        if len(buf) > self.window:
            del buf[:-self.window]
        # a report carrying errors marks the replica unhealthy until a clean
        # report arrives — this is how a crashed remote replica surfaces as a
        # straggler instead of silently vanishing from the fleet view
        self._errored[report.replica_id] = report.n_errors
        if report.latency_ms_samples:
            m = float(np.mean(report.latency_ms_samples))
            prev = self._lat_ewma.get(report.replica_id, m)
            self._lat_ewma[report.replica_id] = 0.8 * prev + 0.2 * m
        elif report.n_requests == 0:
            # an idle window (parked / evacuated / tombstoned replica) ends
            # the replica's latency evidence: without this, a parked
            # straggler's stale high EWMA would keep it flagged forever,
            # skew the fleet median, and re-condemn it the moment a
            # scale-up revives it
            self._lat_ewma.pop(report.replica_id, None)

    def aggregate(self, tick: int, *, n_replicas: int,
                  max_replicas: int) -> dict:
        """Fleet-level record for this tick (the DNN's input record).

        Staleness is handled per channel KIND.  Gauges (util, queue depth,
        transport) decay by 0.5**stale — a silent replica's last level is
        still weak evidence of its current level.  EVENT channels (latency
        samples, request/error counts) are folded in exactly once, tracked
        by a per-replica consumed-tick watermark: those events happened
        once, in the window they were reported — replaying them every
        aggregate counted each completed request and its latency once per
        tick of silence, while keying on ``stale == 0`` would silently drop
        any report that lands an aggregate tick late (transport delay, tick
        misalignment), permanently undercounting fleet throughput/errors.

        Replicas silent past max_staleness are PRUNED outright — reports,
        error flags, and latency EWMAs: a retired replica's state must not
        hold collector memory (or a straggler flag) for the rest of the
        run."""
        lat, reqs, errs = [], 0, 0
        spec_prop, spec_acc = 0, 0
        lat_tiers: dict[str, list] = {"interactive": [], "batch": []}
        util = {"flop_util": [], "hbm_util": [], "ici_util": [], "mem_frac": []}
        qd, transport = [], []
        dead = []
        for rid, buf in self.reports.items():
            if not buf:
                dead.append(rid)
                continue
            r = buf[-1]
            stale = tick - r.tick
            if stale > self.max_staleness:
                dead.append(rid)      # long-gone replica: age out entirely
                continue
            w = 0.5 ** stale          # decay stale replicas' gauges
            last = self._consumed.get(rid)
            fresh = [rep for rep in buf
                     if (last is None or rep.tick > last) and rep.tick <= tick]
            for rep in fresh:
                lat.extend(rep.latency_ms_samples)
                for t, samples in (rep.lat_tiers or {}).items():
                    lat_tiers.setdefault(t, []).extend(samples)
                reqs += rep.n_requests
                errs += rep.n_errors
                # EVENT channel, same exactly-once fold: speculation counts
                # happened once, in the window they were reported
                spec_prop += rep.spec_proposed
                spec_acc += rep.spec_accepted
            if fresh:
                # watermark = highest CONSUMED report tick (not the aggregate
                # tick): a report delayed past an intervening aggregate is
                # still folded in once it finally lands
                self._consumed[rid] = max(rep.tick for rep in fresh)
            for k in util:
                util[k].append(getattr(r, k) * w)
            qd.append(r.queue_depth * w)
            transport.append(r.transport_ms * w)
        for rid in dead:
            del self.reports[rid]
            self._errored.pop(rid, None)
            self._lat_ewma.pop(rid, None)
            self._consumed.pop(rid, None)
        lat_arr = np.asarray(lat) if lat else np.zeros(1)
        rec = {
            "tick": tick,
            "latency_p50": float(np.percentile(lat_arr, 50)),
            "latency_p95": float(np.percentile(lat_arr, 95)),
            "latency_mean": float(np.mean(lat_arr)),
            "throughput": float(reqs),
            "error_rate": errs / max(reqs, 1),
            "rps": float(reqs),
            "queue_depth": float(np.mean(qd)) if qd else 0.0,
            "transport_ms": float(np.mean(transport)) if transport else 0.0,
            # acceptance this tick; a fleet with speculation off (or no
            # drafts found) reads 0.0, never NaN
            "accept_rate": spec_acc / max(spec_prop, 1),
            # per-tier SLO channels: 0.0 when a tier completed nothing this
            # tick (a single-tier fleet reads a flat 0 on the other lane)
            "latency_p95_interactive": (
                float(np.percentile(np.asarray(lat_tiers["interactive"]), 95))
                if lat_tiers["interactive"] else 0.0),
            "latency_p95_batch": (
                float(np.percentile(np.asarray(lat_tiers["batch"]), 95))
                if lat_tiers["batch"] else 0.0),
            "replicas_frac": n_replicas / max(max_replicas, 1),
            **{k: float(np.mean(v)) if v else 0.0 for k, v in util.items()},
        }
        # fleet-level event channels: per-tick deltas of the router's
        # lifetime counters (0.0 when observe_fleet was never called — old
        # traces and bare-collector tests read flat zeros)
        for k in FLEET_EVENT_KEYS:
            total = self._fleet_totals.get(k, 0.0)
            rec[k] = max(total - self._fleet_consumed.get(k, 0.0), 0.0)
            self._fleet_consumed[k] = total
        self.fleet_records.append(rec)
        if len(self.fleet_records) > 4 * self.window:
            del self.fleet_records[:-2 * self.window]
        return rec

    def stragglers(self) -> list[int]:
        """Replicas whose latency EWMA exceeds straggler_factor × median,
        plus any replica whose latest report carried errors (a crashed
        remote replica reports n_errors > 0 via its parent-side stub — it
        must show up here even in a fleet too small for the median test)."""
        out = [rid for rid, e in self._errored.items() if e > 0]
        if len(self._lat_ewma) >= 3:
            med = float(np.median(list(self._lat_ewma.values())))
            out.extend(rid for rid, v in self._lat_ewma.items()
                       if v > self.straggler_factor * med and rid not in out)
        return out

    def window_values(self, key: str, n: int = 32) -> np.ndarray:
        return np.asarray([r.get(key, 0.0) for r in self.fleet_records[-n:]])

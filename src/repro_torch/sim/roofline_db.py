"""Roofline database: the bridge between the dry-run cells and the cluster
simulator (the "grounding loop"; ``repro.sim.roofline_db`` on H100
constants).

Reads results/torch_dryrun/<arch>__<shape>__<mesh>.json, written by
``repro_torch.launch.dryrun``, and derives the three roofline terms per
device:

    compute    = FLOPs_dev / PEAK_FLOPS
    memory     = bytes_dev / HBM_BW
    collective = coll_bytes_dev / ICI_BW

The mesh tags are the reference's: ``single`` the (16, 16) ("data",
"model") production mesh (256 chips), ``multi`` the (2, 16, 16) one (512
chips); the port counts one lone position of the mesh, so its record
holds one device's FLOPs, bytes and wire bytes, as the reference's
per-device XLA count does, and ``chips`` comes from the record.  ``card``
is one card's share of a cell on one device (chips 1), which the planner
(``ServiceProfile.from_db``) reads.

A record in the reference's format reads as the reference reads it: scan
bodies are counted once by XLA's cost analysis, so totals prefer the
unrolled-probe linear fit when present (rec["probe"]), plus an analytic
correction for FLOPs inside *time*-scans (SSM recurrences) that even the
probes cannot see.  The port's own records carry ``scan_flops_counted``
(its eager count sees every scan step) and take no correction.
step_time_s() = max(terms) (perfect-overlap roofline).

When a cell's JSON is missing (dry-run still running), an analytic fallback
estimates the terms from the model config — benchmarks stay runnable, and
the report marks which cells are measured vs estimated.  It divides the
ShapeCfg's whole work over the tag's chips (``MESH_CHIPS``: 256 for
``single``, as the reference's fallback, 512 for ``multi``, 1 for
``card``).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.models import SHAPES

# NVIDIA H100 80GB HBM3 (SXM, 700 W) data-sheet figures, per card
PEAK_FLOPS = 989e12          # dense bf16 tensor-core rate
HBM_BW = 3.35e12             # bytes/s
ICI_BW = 450e9               # bytes/s, NVLink, one direction

DEFAULT_DIR = Path("results/torch_dryrun")
# the chips of each mesh tag's cell (the analytic fallback's divisor)
MESH_CHIPS = {"single": 256, "multi": 512, "card": 1}


def ssm_scan_flops(cfg, shape) -> float:
    """Analytic FLOPs of the recurrence body that lax.scan-over-time hides
    from cost_analysis (per device, whole step).  ≈1-5% of layer FLOPs —
    reported for honesty, added to the compute term."""
    if cfg.ssm is None:
        return 0.0
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    N = cfg.ssm.d_state
    if cfg.ssm.version == 1:
        per_tok = 6 * cfg.d_inner * N            # decay·h + dtBx + C·h
    else:
        H, hd = cfg.ssm_heads, cfg.ssm.headdim
        per_tok = 6 * H * hd * N
    mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd
    return cfg.n_layers * per_tok * tokens * mult


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    flops: float                 # per device
    bytes: float                 # per device (HBM traffic)
    coll_bytes: float            # per device (wire)
    chips: int
    measured: bool               # True = from compiled dry-run
    mem_per_dev: float = 0.0     # bytes (args+temps), from memory_analysis

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / ICI_BW

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)


class RooflineDB:
    def __init__(self, directory: str | Path = DEFAULT_DIR):
        self.dir = Path(directory)
        self._cache: dict[tuple, RooflineTerms] = {}

    def _load(self, arch: str, shape_name: str, mesh: str):
        p = self.dir / f"{arch}__{shape_name}__{mesh}.json"
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def terms(self, arch: str, shape_name: str, mesh: str = "single"
              ) -> RooflineTerms:
        key = (arch, shape_name, mesh)
        if key in self._cache:
            return self._cache[key]
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        rec = self._load(arch, shape_name, mesh)
        if rec is not None:
            chips = rec["chips"]
            if "probe" in rec:
                flops = rec["probe"]["flops"]["total"]
                byts = rec["probe"]["bytes"]["total"]
                coll = rec["probe"]["coll"]["total"]
            else:
                flops = rec["cost"]["flops"]
                byts = rec["cost"]["bytes"]
                coll = rec["collective_bytes"]
            if not rec.get("scan_flops_counted"):
                flops += ssm_scan_flops(cfg, shape) / chips
            mem = rec.get("memory", {})
            mem_b = float(mem.get("argument_size_in_bytes", 0)
                          + mem.get("temp_size_in_bytes", 0))
            t = RooflineTerms(flops=max(flops, 0.0), bytes=max(byts, 0.0),
                              coll_bytes=max(coll, 0.0), chips=chips,
                              measured=True, mem_per_dev=mem_b)
        else:
            t = self._analytic(cfg, shape, MESH_CHIPS.get(mesh, 256))
        self._cache[key] = t
        return t

    # ------------------------------------------------------- analytic fallback

    def _analytic(self, cfg, shape, chips: int) -> RooflineTerms:
        n_active = cfg.active_params()
        if shape.kind == "train":
            tokens = shape.global_batch * shape.seq_len
            flops = 6 * n_active * tokens * 1.33 / chips      # remat ×4/3
            byts = (4 * cfg.n_params() * 3 + tokens * cfg.d_model * 2
                    * cfg.n_layers * 0.25) / chips
            coll = 12 * cfg.n_params() / chips                # grad RS+AG fp32
        elif shape.kind == "prefill":
            tokens = shape.global_batch * shape.seq_len
            flops = 2 * n_active * tokens / chips
            byts = (2 * cfg.n_params() + tokens * cfg.d_model * 2 * 4) / chips
            coll = 2 * tokens * cfg.d_model * 2 * cfg.n_layers / chips
        else:
            tokens = shape.global_batch
            flops = 2 * n_active * tokens / chips
            kv = (2 * cfg.n_layers * max(cfg.n_kv_heads, 1) * cfg.hd
                  * min(shape.seq_len, cfg.sliding_window or shape.seq_len)
                  * shape.global_batch * 2)
            byts = (2 * cfg.n_params() + kv) / chips
            coll = 2 * tokens * cfg.d_model * 2 * cfg.n_layers / chips
        return RooflineTerms(flops=flops, bytes=byts, coll_bytes=coll,
                             chips=chips, measured=False)

    def step_time_s(self, arch: str, shape_name: str, mesh: str = "single"
                    ) -> float:
        return self.terms(arch, shape_name, mesh).step_time

#!/usr/bin/env python3
"""Run ``chip_smoke.py`` from two checkouts in turns on one card and set
their numbers side by side.

    python3 scripts/compare_trees.py OTHER_CHECKOUT [--rounds N] [--out DIR]

Each round runs the other checkout, this one, this one, the other, so a
drift of the card's clocks weighs on both sides alike.  Every run's full
output goes to ``DIR/compare_<side>_<n>.log`` (default ``build/compare``,
git-ignored).  The summary lists, run by run: phase 5's tick and
admission lines (host clock, device busy), each kernel's time from the
kernels line, and phase 2's zamba2-2.7b and write-instance lines.  Exits
non-zero if any run fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEEP = (" tick: ", "admission (", "  zamba2 ", "decode_attention_write ",
        "decode_attention_paged_write ")


def run(tree: Path, log: Path) -> str:
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=1100)
    log.write_text(proc.stdout)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}/chip_smoke.py exited {proc.returncode}: "
                         f"see {log}")
    return proc.stdout


def summary(text: str) -> list[str]:
    lines = [ln.rstrip() for ln in text.splitlines()
             if any(k in ln for k in KEEP)]
    for ln in text.splitlines():
        if ln.startswith('{"kernels"'):
            lines += [f"  {k['name']}: {k['ms']:.4f} ms ({k['launches']} "
                      f"launches)" for k in json.loads(ln)["kernels"]]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "compare",
                    help="directory for each run's full output")
    args = ap.parse_args(argv)
    other = args.other.resolve()
    if not (other / "chip_smoke.py").is_file():
        raise SystemExit(f"{other} holds no chip_smoke.py")
    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; other: {other}; this: {ROOT}")
    n = 0
    for _ in range(args.rounds):
        for side, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                           ("other", other)):
            n += 1
            log = args.out / f"compare_{side}_{n}.log"
            text = run(tree, log)
            print(f"[run {n}: {side}] ({log.name})")
            print("\n".join(summary(text)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

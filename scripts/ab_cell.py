#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Compare two trees of the repo on one benchmark cell, in turns.

    python3 scripts/ab_cell.py --parent DIR --cell NAME [--pairs 10]
                               [--seed 2026] [--out DIR]

Runs ``python3 bench_torch.py --cell NAME --seed SEED`` in ``--parent`` and
in this tree (the change), each run its own process, ``--pairs`` times
each, alternating which side runs first (parent, change; change, parent;
...): a process or a machine can sit a third off its neighbours, so the
two sides share every stretch of the call. Each run's JSON line and its
log go to ``--out``. Prints one JSON line per run, then a summary: for
each side the per-run medians of ``sweep_wall_s`` and of the codec phase
with their median and quartiles, every run's ``correct`` and failed rows,
the traced device-busy share, and the pairs the change won (its median
below the parent's in the same pair).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CHANGE = Path(__file__).resolve().parents[1]


def run(tree: Path, cell: str, seed: int, log: Path) -> dict:
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.run(
            [sys.executable, "bench_torch.py", "--cell", cell,
             "--seed", str(seed)], cwd=tree, stdout=subprocess.PIPE,
            stderr=err, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1]) if lines else {}
    layers = rec.get("layers", {})
    return {"rc": proc.returncode,
            "process_s": time.perf_counter() - t0,
            "correct": rec.get("correct"),
            "rows_failed": rec.get("rows_failed"),
            "sweep_wall_s": rec.get("sweep_wall_s"),
            "codec_s": layers.get("codec_s", {}).get("median"),
            "busy_share": rec.get("trace", {}).get("device_busy_share"),
            "card": rec.get("device", {}).get("card"),
            "record": rec}


def quartiles(xs) -> dict:
    a = np.asarray([x for x in xs if x is not None], np.float64)
    if a.size == 0:
        return {"median": None, "q1": None, "q3": None, "n": 0}
    return {"median": float(np.median(a)),
            "q1": float(np.percentile(a, 25)),
            "q3": float(np.percentile(a, 75)), "n": int(a.size)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--out", type=Path, default=CHANGE / "runs" / "ab")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    trees = {"parent": args.parent.resolve(), "change": CHANGE}
    runs = {"parent": [], "change": []}
    wins = 0
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        got = {}
        for side in order:
            tag = f"{args.cell}_s{args.seed}_{i:02d}_{side}"
            r = run(trees[side], args.cell, args.seed,
                    args.out / f"ab_{tag}.log")
            (args.out / f"ab_{tag}.json").write_text(
                json.dumps(r["record"]))
            del r["record"]
            got[side] = r
            runs[side].append(r)
            print(json.dumps({"pair": i, "side": side, **r}), flush=True)
        med = {s: (got[s]["sweep_wall_s"] or {}).get("median")
               for s in got}
        if None not in med.values() and med["change"] < med["parent"]:
            wins += 1
    summary = {"cell": args.cell, "seed": args.seed, "pairs": args.pairs,
               "change_wins": wins}
    for side, rs in runs.items():
        summary[side] = {
            "sweep_wall_s": quartiles(
                [(r["sweep_wall_s"] or {}).get("median") for r in rs]),
            "codec_s": quartiles([r["codec_s"] for r in rs]),
            "busy_share": [r["busy_share"] for r in rs],
            "correct": [r["correct"] for r in rs],
            "rows_failed": [r["rows_failed"] for r in rs],
            "rcs": [r["rc"] for r in rs],
            "cards": sorted({str(r["card"]) for r in rs})}
    print(json.dumps(summary), flush=True)
    ok = all(r["rc"] == 0 and r["correct"] for rs in runs.values()
             for r in rs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

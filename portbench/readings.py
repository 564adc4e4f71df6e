"""The readings each limit of `limits/<workload>.json` is set from.

    python3 portbench/readings.py --workload <name> --seeds <n,n,...>
        [--controls 3] [--faults 3] [--seconds 2] [--out <file.jsonl>]

For every seed it sets the cell up and drives a window of `--seconds` as
a run does, and judges against the float64 reference:

  program      what the timed path produced: the lower readings;
  control.*    on the first `--controls` seeds, the reference put in the
               program's place in the precision below the configuration's
               (tf32) and in bfloat16, and the program's own lower-precision
               path where it has one (the sampler's bf16 gather): the
               upper readings;
  fault.*      on the first `--faults` seeds, the program with each of the
               faults of `portbench/faults.py` planted.

The program's bf16 gather and the faults are run again from the start of
what the check follows, on the traffic's set-up steps (`rerun()`); the
program's readings and the reference's controls also take in the window.

One JSON line per seed and kind goes to `--out`; the summary (for each
number: the largest program reading, the smallest of each control and
fault) is printed last. Needs a card, as a run does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH.parent / "src")]


def readings(workload: str, seed: int, controls: bool, faults: bool, seconds: float,
             device: str = "cuda", root: Path | None = None) -> list[dict]:
    import torch

    from portbench import faults as bfaults
    from portbench.harness import cell, spec

    root = spec.ROOT if root is None else root
    c = spec.cell(workload, root)
    kind = c.traffic["driver"]
    t0 = time.perf_counter()
    drv = spec.driver(c.traffic, root).Driver(c.config, c.traffic, seed, device,
                                              cell.Spans(device))
    cell._window(drv, seconds, device)
    produced = {"program": drv.outputs()}
    setup = time.perf_counter() - t0
    if faults:
        for f in bfaults.FAULTS[kind]:
            with bfaults.plant(kind, f):
                produced[f"fault.{f}"] = drv.rerun()
    if controls and kind == "gibbs":
        drv.sampler.bf16_gather = True
        produced["control.program_bf16_gather"] = drv.rerun()
    drv.release()
    if controls:
        for p in ("tf32", "bf16"):
            produced[f"control.{p}"] = drv.control(p)
    t1 = time.perf_counter()
    ref = drv.reference()
    out = []
    for name, got in produced.items():
        numbers = drv.judge(got, ref)
        out.append({"workload": workload, "seed": seed, "kind": name,
                    "numbers": numbers, "failed": drv.failed})
    if device == "cuda":
        torch.cuda.synchronize()
    out.append({"workload": workload, "seed": seed, "kind": "timing",
                "setup_s": setup, "judge_s": time.perf_counter() - t1})
    return out


def summary(lines: list[dict]) -> dict:
    """For each kind and number: the largest reading of the program, the
    smallest of each control and fault."""
    out: dict = {}
    for line in lines:
        if "numbers" not in line:
            continue
        pick = max if line["kind"] == "program" else min
        kind = out.setdefault(line["kind"], {})
        for name, v in line["numbers"].items():
            kind[name] = v if name not in kind else pick(kind[name], v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    lines = []
    for i, seed in enumerate(seeds):
        got = readings(args.workload, seed, i < args.controls, i < args.faults, args.seconds)
        for line in got:
            print(json.dumps(line), flush=True)
        lines += got
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.writelines(json.dumps(x) + "\n" for x in got)
    print(json.dumps({"workload": args.workload, "summary": summary(lines)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

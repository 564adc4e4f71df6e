"""Run one cell of the port's benchmark on this machine's card(s).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix and
metrics are named in BENCHMARK.json. The run makes its inputs from the
seed, sets up the program (`src/repro_torch`), measures for `--seconds`
(`--trace 1`: a traced window, for the per-layer metrics), checks what the
timed path produced against the plain reference, and prints one JSON
object as the last line of standard output; the numbers compared, each
beside its limit, are the last lines of standard error. It exits non-zero,
printing no result, where there is no card or too few, or where the
process holds JAX or the JAX package once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
# every compiler cache at a fixed path inside the checkout, set before
# torch is imported; the port's nvcc builds go to build/repro_torch/
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# set-up is timed from here: torch's own import, the same for every
# version of the program and the most the host's speed swings, is left out
import torch  # noqa: E402,F401

T0 = time.perf_counter()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import cell

    try:
        result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                          t0=T0, log=lambda s: print(s, file=sys.stderr, flush=True))
    except cell.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        print("no result: the run failed", file=sys.stderr)
        return 1
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
        if c["value"] is not None and not math.isfinite(c["value"]):
            c["value"] = None   # JSON has no NaN or infinity
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

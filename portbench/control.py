"""The control of a cell's comparison, on the card at the cell's own size:

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

For each seed it makes the run's blob pool and seeds, puts the plain
reference computed one blowup lower (the configuration's Reed-Solomon rate
broken: half the extension, the step that would halve the work) in the
program's place for as many requests as a run compares, and compares those
requests with the reference at the configuration's protocol, as a run
does. Every number compared has to come out above its limit. One JSON line
a seed: the numbers, and the seconds the reference took. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def control(root: pathlib.Path, workload: str, seed: int, device: str) -> dict:
    cell = harness.load_cell(root, workload)
    low = dataclasses.replace(cell.proto, log_blowup_factor=cell.proto.log_blowup_factor - 1)
    data = harness.Data(seed, int(cell.config["blob_bytes"]), cell.pool, cell.blobs)
    system = harness.Reference(cell, device, low)
    kept = []
    for i in range(cell.check_requests):
        t0 = time.perf_counter()
        out = system(data.blob_copies(i), data.request_seeds(i))
        kept.append((harness.Request(i, t0, time.perf_counter(), 0), out))
    t0 = time.perf_counter()
    checks = harness.check_outputs(cell, data, kept, harness.Reference(cell, device))
    return {"workload": workload, "seed": seed, "checks": checks, "reference_s": time.perf_counter() - t0,
            "control_s": sum(r.t1 - r.t0 for r, _ in kept),
            "correct": all(c["value"] <= c["limit"] for c in checks.values())}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    for seed in args.seeds:
        print(json.dumps(control(pathlib.Path.cwd(), args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

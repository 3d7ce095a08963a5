"""The readings a cell's limits are set from, on the card.

    python -m benchmark.calibrate --workload <cell> --seconds <s> --seeds S1 S2 ... [--controls N]

For each seed, in one process, a whole run of the cell (``harness.run``:
set-up with the checked chunk, the window of ``--seconds`` and, on the
planned path, the late chunk from the state the window reached) and the
check's numbers of the program against the reference (the lower
readings).  For the first ``--controls`` seeds also, each against the
reference over the same chunks: the control, the reference in the
precision below the one the cell states (its traffic's ``control``: fp8
for the bf16 kernels, TF32 for the f32 networks); the reference at bf16
operands (what the kernels' precision alone gives) and with the color
network's alone at bf16; half of each ray batch left out, the mean taken
over the rest, and a step that leaves its state unchanged (the faults
the check must catch).  One JSON line a seed, then the largest program
readings and the smallest of each control and fault.  Not run by the
benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from benchmark import cells, harness
    cell = cells.cell(args.workload)
    if args.device == "cuda":
        from fmov_pose_torch.ops import build
        build.build_all(cell["traffic"]["kernels"])
    rows = []
    for i, seed in enumerate(args.seeds):
        res = harness.run(cell, seed, args.seconds, False, args.device,
                          controls=i < args.controls)
        r = res["readings"] or {"program": res["numbers"]}
        r.update(seed=seed, correct=res["correct"],
                 rays_per_s=res["metrics"]["rays_per_s"]["value"])
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for key, agg in (("program", max), ("control", min), ("half_batch", min),
                     ("state_unchanged", min), ("bf16", max), ("color_bf16", min)):
        have = [r[key] for r in rows if key in r]
        if have:
            summary[key] = {n: agg(h[n] for h in have if n in h) for n in have[0]}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()

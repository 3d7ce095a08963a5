"""Run one cell of the benchmark of ``fmov_pose_torch`` on the CUDA card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints one JSON line last on standard
output: ``correct``, ``attempted`` (the window's training steps),
``failed``, ``metrics`` (with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checked``: each number of the check with its
limit, which also end standard error.  Exits non-zero, printing no
result, without a CUDA card (or with fewer than the cell asks for), and
when JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_IMPORT = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of a run at a fixed path in the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import cells, harness
    cell = cells.cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    from fmov_pose_torch.ops import build
    build.build_all(cell["traffic"]["kernels"])
    res = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded once the window closed: {bad}", file=sys.stderr)
        return 3
    harness.print_result(res, torch.cuda.get_device_name(0), cell["chips"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

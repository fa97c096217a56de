"""The benchmark of ``picasso_torch`` on the card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (import, the CUDA context, the kernel library from
``picasso_torch/.build/``, built there at the first run of a checkout;
the cell's inputs made on the card from the seed; one warm call at the
cell's shapes), then the calls of the cell's driver for ``--seconds``,
then the check against the plain reference, then one JSON line as the
last line of standard output (with ``--trace 1`` the per-layer metrics
of a profiled window). Each number compared is printed beside its limit
on standard error, and last in the line, under ``checks``. Without the
cards the cell asks for, or with JAX or the JAX package loaded at the
end, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT), str(BENCH)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from core import device as dev_info

    try:
        import picasso_torch
    except ImportError as exc:
        print(f"the program is missing: {exc}", file=sys.stderr)
        return 3
    if Path(picasso_torch.__file__).resolve().parent.parent != ROOT:
        print(f"picasso_torch comes from {picasso_torch.__file__}, not from "
              f"this checkout ({ROOT})", file=sys.stderr)
        return 3
    from core.harness import run_cell

    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except dev_info.NoDevice as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    found = dev_info.forbidden_modules(sys.modules)
    if found:
        print(f"no result: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

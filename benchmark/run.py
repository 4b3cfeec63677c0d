#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic mix, kind, limits and per-layer readers are
files under ``benchmark/`` found by name (``README.md``). The last line on
standard output is the result as one JSON object. Without a CUDA card the
run exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True, help="A cell of BENCHMARK.json.")
    parser.add_argument("--seed", type=int, required=True, help="Seeds inputs and weights.")
    parser.add_argument("--seconds", type=float, required=True, help="The measured window.")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0,
                        help="1: report the per-layer metrics of a traced stretch.")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # Compile caches at fixed paths inside the checkout, whatever the
    # environment says, so only a checkout's first run fills them.
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())

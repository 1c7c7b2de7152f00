"""Run one cell of the benchmark and print its result line.

    python3 jpegbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this directory
and ``jpeglibrary_tpu_torch``. Exits with a code other than 0, and prints
no result, without a CUDA device (or with fewer than the cell asks for),
when the program cannot be imported, or when JAX or the JAX package has
been loaded.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from jpegbench.core import harness

    try:
        record = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    except harness.RunError as e:
        print(f"jpegbench: {e}", file=sys.stderr)
        return 2
    harness.emit(record)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one benchmark cell of the PyTorch port.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. See ``port_bench/README.md``.
"""

import time

# set-up is timed from here, before any heavy import
PROCESS_START = time.perf_counter()


def main() -> int:
    from port_bench import harness
    return harness.main(start=PROCESS_START)


if __name__ == "__main__":
    raise SystemExit(main())

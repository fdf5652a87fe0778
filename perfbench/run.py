"""Entry point: `python3 -m perfbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` (see perfbench.harness)."""

import time

STARTED = time.perf_counter()

if __name__ == "__main__":
    import sys

    from perfbench.harness import main

    sys.exit(main(started=STARTED))

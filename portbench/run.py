"""One run of a benchmark cell; prints one JSON line (see harness.py):

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))

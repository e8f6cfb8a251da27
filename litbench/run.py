"""Run one cell of the benchmark of litbox_tpu_torch once.

    python3 litbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
generator and its metrics are found by name (see litbench/README.md). The last
line of standard output is one JSON object: correct, attempted, failed,
metrics, device, with --trace 1 also breakdown, and last the numbers that
decided `correct`, each beside its limit.
"""

import time

T0 = time.perf_counter()  # setup_s counts from here: imports included

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every build and kernel cache lives at a fixed path inside the checkout, set
# before torch is imported. The port's kernel library and EXR decoder build
# into litbox_tpu_torch/_build/<hash>/, which is inside the checkout too.
_CACHE = os.path.join(ROOT, ".litbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from litbench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], ROOT, T0))

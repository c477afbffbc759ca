"""The benchmark of ``safelife_torch`` on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell names a configuration and a
traffic mix in ``BENCHMARK.json``; everything else is found by name under
``portbench/``.  The last line of standard output is the run's JSON
result; the numbers that decided ``correct`` end standard error.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")

# Bytecode of every module the run imports, kept in the checkout so that
# later runs load it (the card's Python sets PYTHONDONTWRITEBYTECODE).
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False
os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_ext"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.harness import cli
    sys.exit(cli.main(sys.argv[1:], T_START))

"""Run one benchmark cell once (see ``perfbench/harness.py``):

    python3 perfbench/run.py --workload W --seed N --seconds S --trace 0|1

The checkout's ``src`` holds the program under test; its build and kernel
caches go to fixed directories under the checkout's ``build``."""
import os
import sys
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
if sys.path[2] == os.path.dirname(os.path.abspath(__file__)):
    del sys.path[2]                  # the script's own folder
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "perfbench", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

if __name__ == "__main__":
    from perfbench.harness import main
    sys.exit(main(sys.argv[1:], STARTED))

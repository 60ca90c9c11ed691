"""Run one benchmark cell of ``repro_torch``'s mesh-integrated federated
boost and print its result as the last line of standard output.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.  The
cell is looked up by name in ``BENCHMARK.json``.  ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics; both check
one federation of the timed window against the plain reference.  The run
fails, printing no result, where there is no card, where the program's
sources are missing, or where JAX or the JAX package is loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache the run could write stays in the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program's sources (src/repro_torch) are "
              "missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from perfbench import harness
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w for w in spec["workloads"]}[a.workload]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {a.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result = harness.run(spec, a.workload, a.seed, a.seconds,
                         bool(a.trace), "cuda", T_PROCESS)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perfbench: loaded {loaded}", file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

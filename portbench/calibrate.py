"""Readings that a cell's limits are set from (not part of a run).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control] [--faults]

For each seed: the program's first steps against the plain reference (the
sound reading), and with ``--control`` the reference computed in TF32 put
in the program's place, with ``--faults`` the program with each planted
fault.  One JSON line a seed on standard output, every compared number's
value, at the cell's own sizes.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)

    from portbench.bench.faults import FAULTS, planted
    from portbench.bench.harness import Registry
    from portbench.reference.compare import readings_gaps

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    reg = Registry(ROOT / "portbench")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    make = reg.driver(config["driver"]).Driver
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = make(config, traffic, seed, "cuda", {})
        drv.setup(0)
        runs = {"sound": drv.readings}
        drv.release()
        if args.faults:
            for kind in FAULTS:
                with planted(kind):
                    drv.setup(0)
                runs[kind] = drv.readings
                drv.release()
        ref = drv.reference()
        if args.control:
            runs["control"] = drv.reference(tf32=True)
        out = {"workload": args.workload, "seed": seed,
               "seconds": time.perf_counter() - t0}
        out.update({k: readings_gaps(v, ref) for k, v in runs.items()})
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of ``correct`` are set from, on the chip.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 2]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, then the compared numbers of the program against the
plain reference.  On the control seeds also the control's numbers (the
reference in float8 put in the program's place: ``ctrl.*``) and, for a
training cell, a planted fault (the mean over half of each batch:
``half.*``).  One JSON line per seed.  The benchmark's own runs never run
this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    from portbench import env

    env.setup()
    import torch

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA card")
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    files = harness.cell_files(bench, args.workload)
    dev = torch.device("cuda", 0)
    print(f"card: {harness.card()}", file=sys.stderr, flush=True)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")] + sorted(control)
    for seed in dict.fromkeys(seeds):
        t0 = time.time()
        cell = files.kind.Cell(files.cfg, files.traffic, files.spec, seed, dev)
        cell.warmup()
        cell.finish()
        setup = time.time() - t0
        w = harness.window(cell, args.seconds)
        cell.release()
        modes = ("fp32",) + (("fp8", "half") if seed in control else ())
        t1 = time.time()
        if files.traffic["kind"] != "train":
            modes = tuple(m for m in modes if m != "half")
        readings = cell.readings(modes=modes)
        print(json.dumps({"seed": seed, "setup_s": setup, "units": w.units,
                          "unit_s": w.seconds / w.units, "check_s": time.time() - t1,
                          **readings}), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

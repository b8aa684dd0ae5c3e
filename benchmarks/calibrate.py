"""Readings that the limits of ``correct`` are set from, on the card.

    python benchmarks/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3]

For each seed in ``--seeds``: the cell's data, one fit of the program at
the cell's schedule on run seed ``data.run_seed(seed, 0)``, the
reference on the same seed in float64 and in float32 (TF32 off), and
every number fitbench/check.py computes - the sound readings.  For each
of ``--control-seeds``: the reference computed with TF32 products (the
nearest precision below the configuration's float32) put in the
program's place and judged the same way - the control's readings.  One
JSON line per reading.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(1, os.path.dirname(here))
    import torch

    import dcfm_tpu_torch
    from fitbench import cell as runner, check, data, spec

    cell = spec.load_cell(args.workload)
    config, traffic = cell.config, cell.traffic
    dev = torch.device("cuda:0")

    def seeds(text):
        return [int(x) for x in text.split(",") if x]

    def say(kind, seed, got, t, out=sys.stdout):
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "numbers": got,
                          "seconds": round(time.perf_counter() - t, 2)}),
              file=out, flush=True)

    wanted = {}
    for kind, text in (("sound", args.seeds),
                       ("control", args.control_seeds)):
        for s in seeds(text):
            wanted.setdefault(s, []).append(kind)
    for s, kinds in wanted.items():
        t = time.perf_counter()
        Y = data.make_data(config["data"], s, dev)
        rs = data.run_seed(s, 0)
        exact, prep = check.reference(Y, config, traffic, rs, dev,
                                      dtype=torch.float64)
        plain, _ = check.reference(Y, config, traffic, rs, dev)
        if "sound" in kinds:
            cfg = runner.fit_config(config, traffic, rs)
            res = dcfm_tpu_torch.fit(Y, cfg, device=dev)
            say("sound", s, check.numbers(
                config, runner.answer_of(config, res), exact, plain, prep),
                t)
            del res
        if "control" in kinds:
            low, _ = check.reference(Y, config, traffic, rs, dev, tf32=True)
            say("control", s, check.numbers(
                config, check.control_answer(config, low, prep), exact,
                plain, prep), t)
            del low
        del exact, plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

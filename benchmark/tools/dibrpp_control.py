#!/usr/bin/env python3
"""The upper readings of a DIB-R++ cell's limits, on the chip.

    python3 benchmark/tools/dibrpp_control.py --workload <cell> \
        --seeds 1,2,3 [--only <reading>,...]

For each seed, ``drivers/dibrpp.py::control``: the reference in bfloat16
and with each planted fault (the specular term left out, half of the
lights left out, the roughness gradient zeroed, half of each step's
views left out), each held against the
reference in float32 by the cell's numbers; the smallest is a limit's
upper reading.  The lower readings are ``benchmark/tools/readings.py
--program``'s.  Prints one JSON line per seed.  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE.parent))

from benchmark.harness import env  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--only', default=None,
                   help='the readings to take, comma-separated (default '
                        'all)')
    args = p.parse_args()
    cell = json.loads((HERE / 'workloads' / f'{args.workload}.json')
                      .read_text())
    config = json.loads((HERE / 'configs' / f'{cell["config"]}.json')
                        .read_text())
    env.pin_caches()
    import torch
    from benchmark.drivers import dibrpp
    env.require_cards(1)
    only = args.only.split(',') if args.only else None
    for seed in (int(s) for s in args.seeds.split(',')):
        t = time.perf_counter()
        res = dibrpp.control(cell, config, seed, torch.device('cuda', 0),
                             only)
        print(json.dumps(dict(seed=seed, kind='control', values=res,
                              seconds=time.perf_counter() - t)), flush=True)
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()

#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \
        [--program] [--control [--only <reading>,...]] [--seconds 1]

``--program``: for each seed, a whole run of the cell (a window of
``--seconds``) and the numbers it compares; the largest over sound seeds
is a limit's lower reading.  ``--control`` (on one card, the reference
alone): for each seed, the reference computed in the next precision below
the configuration's (bfloat16 for float32) put in the program's place, and
the faults planted in the reference (DIB-R: half of each step's views left
out, the mean over the rest; the vertices' or the texture's gradient
negated or doubled; over several cards, also the exchange between them
left out); the smallest is a limit's upper reading.
Prints one JSON line per seed and reading.  The benchmark's own runs never
run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE.parent))

from benchmark.harness import env  # noqa: E402


GRAD_FAULTS = {'fault_vertex_negated': (-1., 1., 1.),
               'fault_vertex_doubled': (2., 1., 1.),
               'fault_texture_negated': (1., -1., 1.),
               'fault_texture_doubled': (1., 2., 1.)}


def dibr_control(cell, config, seed, device, only=None):
    """The control and the faults of a DIB-R cell, the reference alone in
    one process: {name: the numbers of drivers/dibr.py::numbers} and the
    reference's own readings.  A multi-card cell's step is the sum of its
    cards' shares (``shares``), which needs no exchange in one process;
    its fault of the exchange left out is card 0's share alone.  ``only``
    (default all) names the readings to take."""
    import torch
    from benchmark.drivers import dibr
    from benchmark.reference import dibr as ref
    H = W = cell['height']
    cfg = dibr._cfg(config)
    inp = dibr.make_inputs(config, cell, seed, device)
    cards = cell['chips'] if config['driver'] == 'multiview' else 1
    if cards > 1:       # every step all the views, dealt in a seeded order
        rows = inp['rows'][:1].expand(dibr.FIRST_STEPS, -1)
    else:
        rows = inp['rows'][:dibr.FIRST_STEPS]
    per = rows.shape[1] // cards

    def fit(rows=rows, shares=cards, **kw):
        return dibr.reference_readings(ref.fit(
            inp['start'], inp['gt'], inp['views'], inp['faces'],
            inp['face_uvs'], rows, H, W, cfg, dibr.FIRST_STEPS,
            shares=shares, **kw), inp)
    runs = dict(control_bf16=dict(dtype=torch.bfloat16),
                fault_half_batch=dict(views_used=per // 2),
                **{k: dict(grad_scale=v) for k, v in GRAD_FAULTS.items()})
    if cards > 1:
        runs['fault_no_exchange'] = dict(rows=rows[:, :per], shares=1)
    base = fit()
    out = {name: dibr.numbers(fit(**kw), base) for name, kw in runs.items()
           if only is None or name in only}
    out['reference'] = {k: v for k, v in base.items() if k != 'vertex_grads'}
    return out


def spc_control(cell, config, seed, device):
    import torch
    from benchmark.drivers import spc
    from benchmark.harness import scene
    from benchmark.reference import spc as ref
    level = config['level']
    fv, (origin, direction) = spc.make_inputs(config, cell, device)
    turns, N = origin.shape[:2]
    knum = config['trace']['knum']
    order = scene.schedule(seed, turns, 1, cell['rounds']).reshape(-1)
    g = scene.generator(seed, 'cpu')
    sample = cell['sample']
    picked = torch.randperm(sample['within'], generator=g)[:sample['frames']]
    ray_ids = {f: torch.randperm(N, generator=g)[:sample['rays']].to(device)
               for f in sorted(picked.tolist())}
    low = torch.bfloat16
    vox = ref.voxelize(fv, level, dtype=low)
    codes = ref.morton(vox)
    answers = []
    for f, ids in ray_ids.items():
        t = int(order[f % len(order)])
        cnt, tn, vid = ref.trace(vox, level, origin[t][ids],
                                 direction[t][ids], knum, dtype=low)
        answers.append((t, ids, cnt, torch.where(
            vid >= 0, codes[vid.clamp(min=0)], -1), tn))
    octree = ref.octree_bytes(vox, level)
    return dict(control_bf16=spc.compare(octree, vox, fv, level, origin,
                                         direction, answers, knum))


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--program', action='store_true')
    p.add_argument('--control', action='store_true')
    p.add_argument('--only', default=None,
                   help='the control readings to take, comma-separated '
                        '(default all)')
    p.add_argument('--seconds', type=float, default=1.)
    args = p.parse_args()
    spec = json.loads((HERE.parent / 'BENCHMARK.json').read_text())
    entry = next(w for w in spec['workloads'] if w['name'] == args.workload)
    cell = json.loads((HERE / 'workloads' / f'{args.workload}.json')
                      .read_text())
    config = json.loads((HERE / 'configs' / f'{entry["config"]}.json')
                        .read_text())
    env.pin_caches()
    import torch
    from benchmark.harness.context import Ctx
    env.require_cards(entry['chips'] if args.program else 1)
    dev = torch.device('cuda', 0)
    driver = importlib.import_module(f'benchmark.drivers.{config["driver"]}')
    only = args.only.split(',') if args.only else None
    for seed in (int(s) for s in args.seeds.split(',')):
        if args.program:
            t = time.perf_counter()
            out = driver.run(Ctx(
                cell=cell, config=config, seed=seed,
                seconds=args.seconds, trace=False, t0=t, device=dev,
                trace_path=env.CACHE / 'traces' / 'readings.json'))
            print(json.dumps(dict(
                seed=seed, kind='program',
                values={c.name: c.value for c in out.checks},
                failed=out.failed, forbidden=out.forbidden,
                seconds=time.perf_counter() - t)), flush=True)
            torch.cuda.empty_cache()
        if args.control:
            t = time.perf_counter()
            if config['driver'] == 'spc':
                res = spc_control(cell, config, seed, dev)
            else:
                res = dibr_control(cell, config, seed, dev, only)
            print(json.dumps(dict(seed=seed, kind='control', values=res,
                                  seconds=time.perf_counter() - t)),
                  flush=True)
            torch.cuda.empty_cache()


if __name__ == '__main__':
    main()

#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell is an entry of ``BENCHMARK.json``;
its traffic is ``benchmark/workloads/<cell>.json``, its configuration
``benchmark/configs/<config>.json``, whose ``driver`` names
``benchmark/drivers/<driver>.py``.  With ``--trace 0`` the result carries
the cell's end-to-end metrics; with ``--trace 1`` a block after the window
runs under ``torch.profiler`` and the result carries the cell's per-layer
metrics, each read by ``benchmark/metrics/<metric>.py``, and a
``breakdown``.  Every run compares what the timed path produced with the
plain reference (``benchmark/reference/``) and prints each number compared
beside its limit, last on standard error and last in the result line.

Exits non-zero and prints no result where CUDA has fewer cards than the
cell asks for, where the program cannot be imported, and where the JAX
package or JAX is loaded once the window has closed, in this process or
in a rank that a multi-card cell spawns.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from benchmark.harness import env  # noqa: E402


def load_json(path):
    return json.loads(Path(path).read_text())


def find_cell(spec, name):
    """(the cell's BENCHMARK.json entry, its traffic, its configuration)."""
    entry = next((w for w in spec['workloads'] if w['name'] == name), None)
    if entry is None:
        raise SystemExit(f'run.py: no workload {name!r} in BENCHMARK.json')
    cell = load_json(HERE / 'workloads' / f'{name}.json')
    config = load_json(HERE / 'configs' / f'{entry["config"]}.json')
    return entry, cell, config


def metrics_of(spec, key, name):
    """The metrics of ``spec[key]`` that the cell ``name`` reports."""
    return [m for m in spec[key] if name in m.get('workloads', [name])]


def read_metric(name, record):
    """The value that ``metrics/<name>.py`` reads from ``record``, or None."""
    path = HERE / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + name.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(args, spec, out, card, kind):
    """The result line's object, the comparison's key last."""
    if args.trace:
        metrics = {}
        for m in metrics_of(spec, 'per_layer', args.workload):
            value = read_metric(m['name'], out.record)
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=m['unit'])
    else:
        metrics = {m['name']: dict(value=out.values[m['name']],
                                   unit=m['unit'])
                   for m in metrics_of(spec, 'end_to_end', args.workload)}
    device = dict(platform='gpu', kind=kind, count=out.count,
                  memory_peak_bytes=int(out.memory_peak_bytes))
    line = dict(correct=all(c.ok for c in out.checks),
                attempted=out.attempted, failed=out.failed,
                metrics=metrics, device=device)
    if args.trace:
        from benchmark.harness import trace
        # over the cards where the driver gives that (several processes)
        device['busy_s'] = out.record.get('device_busy_s',
                                          out.record['busy_s'])
        device['window_s'] = out.record.get('device_window_s',
                                            out.record['window_s'])
        line['breakdown'] = trace.breakdown(out.record)
    line['card'] = card
    line['checks'] = {c.name: c.as_dict() for c in out.checks}
    return line


def main(argv=None):
    args = parse(argv)
    spec = load_json(HERE.parent / 'BENCHMARK.json')
    entry, cell, config = find_cell(spec, args.workload)
    env.pin_caches()
    import torch
    from benchmark.harness.context import Ctx
    try:
        env.require_cards(entry['chips'])
    except env.NoCard as exc:
        print(f'run.py: {exc}', file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    ctx = Ctx(cell=cell, config=config, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), t0=T0,
              device=torch.device('cuda', 0),
              trace_path=env.CACHE / 'traces' / f'{args.workload}.json')
    driver = importlib.import_module(f'benchmark.drivers.{config["driver"]}')
    out = driver.run(ctx)
    found = [f'this process: {name}' for name in env.forbidden_modules()]
    found += out.forbidden
    if found:
        print(f'run.py: loaded: {", ".join(found)} (the benchmark runs '
              f'without JAX and without the JAX package)', file=sys.stderr)
        return 3
    card = env.card_info()
    line = result_line(args, spec, out, card,
                       torch.cuda.get_device_name(0))
    for c in out.checks:
        print(f'check {c.name}: {c.value!r} (limit {c.limit!r})'
              f'{"" if c.ok else "  FAILED"}', file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == '__main__':
    sys.exit(main())

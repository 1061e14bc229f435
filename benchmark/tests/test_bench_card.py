"""On a machine with a CUDA card: a short run of each one-card cell,
untraced and traced, prints a well-formed result line that is correct.
Skips without a card (the ``card`` fixture decides)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
ONE_CARD = [w['name'] for w in SPEC['workloads'] if w['chips'] == 1]


@pytest.mark.card
@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('cell', ONE_CARD)
def test_short_run(card, cell, trace):
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', cell, '--seed',
         str(2 ** 31 + 101 + trace), '--seconds', '2', '--trace',
         str(trace)], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                              'device']
    assert list(line)[-1] == 'checks'
    assert line['correct'] and line['failed'] == 0, line['checks']
    assert line['device']['platform'] == 'gpu'
    key = 'per_layer' if trace else 'end_to_end'
    want = {m['name'] for m in SPEC[key]
            if cell in m.get('workloads', [cell])}
    assert set(line['metrics']) == want
    if trace:
        assert 0 < line['device']['busy_s'] <= line['device']['window_s']
        assert line['breakdown']['device_ops']

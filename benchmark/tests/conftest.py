"""Shared fixtures of the benchmark's own tests.

Run them from the checkout's root: ``python -m pytest benchmark/tests -q``
(on the CPU; the tests marked ``card`` skip there and run on a machine
with a CUDA card).  The cells run here at small sizes on the program's
plain CPU path.
"""

import copy
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line('markers',
                            'card: needs a CUDA card (skips without one)')


@pytest.fixture
def card():
    """Skips the test where CUDA has no card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def load(kind, name):
    return json.loads((ROOT / 'benchmark' / kind / f'{name}.json')
                      .read_text())


SMALL_DIBR = dict(height=48, view_pool=4, views_per_step=2, rounds=4,
                  mesh=dict(kind='uv_sphere', n_lon=16, n_lat=9))


def small_dibr(cell='dibr.sphere10k.512x4'):
    """(configuration, cell) of a DIB-R cell cut to a CPU test's size."""
    w = load('workloads', cell)
    c = load('configs', w['config'])
    c['texture_res'] = 16
    w.update(copy.deepcopy(SMALL_DIBR))
    return c, w


def small_spc(cell='spc.trace.1m'):
    """(configuration, cell) of the SPC cell cut to a CPU test's size."""
    w = load('workloads', cell)
    c = load('configs', w['config'])
    c.update(level=6, cell_shift=2, cell_width=64)
    c['trace'].update(max_active_blocks=1024, max_super_voxels=64 * 64)
    w['rays'].update(side=64, turns=4)
    w.update(rounds=4, sample=dict(frames=3, within=4, rays=64))
    return c, w


def drive(config, cell, seed=2 ** 33 + 7, seconds=0.5, trace=False,
          tmp=None):
    """One run of a driver on the CPU; returns its Outcome."""
    import importlib
    from benchmark.harness.context import Ctx
    driver = importlib.import_module(f'benchmark.drivers.{config["driver"]}')
    path = Path(tmp or '.') / 'trace.json'
    return driver.run(Ctx(cell=cell, config=config, seed=seed,
                          seconds=seconds, trace=trace,
                          t0=time.perf_counter(), device=torch.device('cpu'),
                          trace_path=path))

"""The multi-card DIB-R cell on two gloo ranks on the CPU at a small size:
its reference matches the program's plain path, a step whose exchange
between cards is left out is not correct, and a forbidden module loaded in
a rank is reported."""

import copy

import pytest

from conftest import drive, load

SMALL = dict(chips=2, height=32, view_pool=4, views_per_step=4, rounds=1,
             mesh=dict(kind='uv_sphere', n_lon=12, n_lat=7))


def small_multiview():
    w = load('workloads', 'dibr.multiview64.1024')
    c = load('configs', w['config'])
    c['texture_res'] = 16
    w.update(copy.deepcopy(SMALL))
    return c, w


def _rank_without_exchange(rank, init_method, args, results):
    """A rank whose all-reduce leaves its gradients and loss as they are."""
    from benchmark.drivers import multiview
    from kaolin_tpu_torch.parallel import sharding
    sharding.Mesh.all_reduce = lambda self, tensor, axis=None: tensor
    multiview._rank(rank, init_method, args, results)


def test_multiview_reference_matches_plain_path(tmp_path):
    out = drive(*small_multiview(), seconds=1., tmp=tmp_path)
    assert out.count == 2 and out.attempted > 0 and out.failed == 0
    for c in out.checks:
        assert c.ok, (c.name, c.value, c.limit)


def test_multiview_exchange_left_out(monkeypatch, tmp_path):
    from benchmark.drivers import multiview
    monkeypatch.setattr(multiview, '_rank', _rank_without_exchange)
    out = drive(*small_multiview(), seconds=1., tmp=tmp_path)
    assert not all(c.ok for c in out.checks)


def _rank_loading_jax(rank, init_method, args, results):
    """A rank in whose process a module named ``jax`` is loaded."""
    import sys
    import types
    from benchmark.drivers import multiview
    sys.modules['jax'] = types.ModuleType('jax')
    multiview._rank(rank, init_method, args, results)


def test_multiview_rank_loading_jax_is_reported(monkeypatch, tmp_path):
    """What a rank loads is its own process's: the run names it."""
    from benchmark.drivers import multiview
    monkeypatch.setattr(multiview, '_rank', _rank_loading_jax)
    out = drive(*small_multiview(), seconds=0.5, tmp=tmp_path)
    assert out.forbidden == ['rank 0: jax', 'rank 1: jax']


def test_multiview_control_fails():
    """The control and the planted faults of the multi-card cell, the
    reference alone in one process, read above its limits
    (``benchmark/tools/readings.py --control``)."""
    import torch
    from benchmark.tools import readings
    config, cell = small_multiview()
    got = readings.dibr_control(cell, config, 2 ** 32 + 3,
                                torch.device('cpu'))
    assert 'fault_no_exchange' in got
    for name, numbers in got.items():
        if name != 'reference':
            assert [k for k, v in numbers.items()
                    if v > cell['limits'][k]], (name, numbers)

"""BENCHMARK.json against the benchmark's contract: every cell,
configuration and metric found by name, names and units of the allowed
characters, the keys each entry may have."""

import json
import re

import pytest

from conftest import ROOT, load

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT = re.compile(r'^[^\t\n]{1,200}$')


def test_top_level_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['command'] == ['python3', 'benchmark/run.py']
    assert SPEC['paths'] == ['benchmark']
    assert isinstance(SPEC['run_seconds'], int)
    assert 1 <= SPEC['run_seconds'] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_full_check_fits():
    cells, r = 24, SPEC['run_seconds']
    assert (2 + 14 * cells) * (r + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize('key', ['configs', 'workloads', 'end_to_end',
                                 'per_layer'])
def test_names(key):
    names = [e['name'] for e in SPEC[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize('entry', SPEC['configs'], ids=lambda e: e['name'])
def test_config_found(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    assert entry['file'] == f'benchmark/configs/{entry["name"]}.json'
    cfg = load('configs', entry['name'])
    assert cfg['name'] == entry['name']
    assert cfg['reduced'] == entry['reduced']
    assert (ROOT / 'benchmark' / 'drivers' / f'{cfg["driver"]}.py').exists()
    assert TEXT.match(entry['source']) and TEXT.match(entry['why'])
    assert entry['source'].startswith('https://')
    used = {w['config'] for w in SPEC['workloads']}
    assert entry['name'] in used


@pytest.mark.parametrize('entry', SPEC['workloads'], ids=lambda e: e['name'])
def test_cell_found(entry):
    assert set(entry) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(entry['traffic']) and NAME.match(entry['config'])
    assert entry['chips'] in (1, 4)
    assert TEXT.match(entry['why'])
    cell = load('workloads', entry['name'])
    assert cell['config'] == entry['config']
    assert cell['chips'] == entry['chips']
    assert cell['why'] == entry['why']
    assert cell['limits'], 'a cell compares at least one number'
    e2e = [m for m in SPEC['end_to_end']
           if entry['name'] in m.get('workloads', [entry['name']])]
    layer = [m for m in SPEC['per_layer']
             if entry['name'] in m.get('workloads', [entry['name']])]
    assert 'setup_s' in [m['name'] for m in e2e] and len(e2e) >= 2
    assert layer


def test_pairs_once():
    pairs = [(w['config'], w['traffic']) for w in SPEC['workloads']]
    assert len(pairs) == len(set(pairs))
    four = sum(w['chips'] == 4 for w in SPEC['workloads'])
    assert four <= max(1, len(SPEC['workloads']) // 4)


@pytest.mark.parametrize('metric', SPEC['end_to_end'],
                         ids=lambda m: m['name'])
def test_end_to_end(metric):
    assert set(metric) <= {'name', 'unit', 'better', 'bound', 'source',
                           'workloads'}
    assert UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    assert metric['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= metric['bound'] <= 0.25


@pytest.mark.parametrize('metric', SPEC['per_layer'],
                         ids=lambda m: m['name'])
def test_per_layer_found(metric):
    assert set(metric) <= {'name', 'unit', 'better', 'source', 'layer',
                           'moves', 'workloads'}
    assert UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    assert metric['source'] in ('device_trace', 'program_span',
                                'program_counter', 'host_clock')
    assert TEXT.match(metric['layer'])
    assert metric['moves'] in [m['name'] for m in SPEC['end_to_end']]
    reader = ROOT / 'benchmark' / 'metrics' / f'{metric["name"]}.py'
    assert reader.exists()
    cells = [w['name'] for w in SPEC['workloads']]
    moved = next(m for m in SPEC['end_to_end'] if m['name'] == metric['moves'])
    for cell in metric.get('workloads', cells):
        assert cell in cells
        assert cell in moved.get('workloads', cells)
    if metric['name'].endswith('_roofline') or 'mfu' in metric['name']:
        assert metric['unit'] == '%'


def test_readers_find_nothing_in_an_empty_record():
    import runpy
    for m in SPEC['per_layer']:
        read = runpy.run_path(str(ROOT / 'benchmark' / 'metrics'
                                  / f'{m["name"]}.py'))['read']
        assert read(None) is None

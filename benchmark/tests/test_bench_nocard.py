"""A run without the cards a cell asks for fails and prints no result; it
never falls back to the CPU.  So does a run in a checkout that holds only
the benchmark."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in SPEC['workloads']]


def run(cwd, cell):
    return subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', cell, '--seed',
         str(2 ** 31 + 11), '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, timeout=300, cwd=cwd)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')


@pytest.mark.parametrize('cell', CELLS)
def test_no_card_no_result(no_card, cell):
    out = run(ROOT, cell)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'torch.cuda.is_available() is False' in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = run(tmp_path, CELLS[0])
    assert out.returncode != 0
    assert out.stdout.strip() == ''

"""The control: the reference computed in bfloat16 (the next precision
below the configurations' float32) put in the program's place fails the
cell's limits, at a size that a test run holds.  On the chip the same
readings, at the cells' own sizes, are ``benchmark/tools/readings.py
--control``'s."""

import torch

from conftest import small_dibr, small_spc
from benchmark.tools import readings


def test_dibr_control_fails():
    config, cell = small_dibr()
    got = readings.dibr_control(cell, config, 2 ** 32 + 3,
                                torch.device('cpu'))
    for name in ('control_bf16', 'fault_half_batch', *readings.GRAD_FAULTS):
        over = [k for k, v in got[name].items() if v > cell['limits'][k]]
        assert over, (name, got[name])


def test_spc_control_fails():
    config, cell = small_spc()
    got = readings.spc_control(cell, config, 2 ** 32 + 3,
                               torch.device('cpu'))['control_bf16']
    over = [k for k in cell['limits'] if k in got and
            got[k] > cell['limits'][k]]
    assert over, got

"""What a driver is given and what it gives back.

A driver (``drivers/<name>.py``) has one function, ``run(ctx)``, which
builds the system under test from the cell's configuration and traffic
and the seed, warms up, measures for ``ctx.seconds``, optionally traces a
block of steps, then compares what the timed path produced with the plain
reference.  It returns an :class:`Outcome`; ``run.py`` turns that into the
result line.
"""

import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ['Ctx', 'Outcome', 'Clock']


@dataclass
class Ctx:
    """A run's parameters.  ``t0`` is the host clock at the process's start
    (``time.perf_counter``); ``device`` the torch device of rank 0."""
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: object
    trace_path: Path


@dataclass
class Outcome:
    """A driver's result: end-to-end values by metric name, the work
    attempted and failed, the numbers compared with their limits, the
    device's peak memory and number of cards, and with tracing on the
    traced block's record for the per-layer readers; ``forbidden`` names
    the forbidden modules that other processes of the run (the ranks of a
    multi-card cell) found loaded in themselves."""
    values: dict
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int
    count: int = 1
    record: dict = field(default=None)
    forbidden: list = field(default_factory=list)


class Clock:
    """The host clock and the device fence of one run."""

    def __init__(self, device):
        import torch
        self.cuda = device.type == 'cuda'
        self._torch = torch

    def sync(self):
        if self.cuda:
            self._torch.cuda.synchronize()

    def now(self):
        return time.perf_counter()

    def peak(self):
        return (self._torch.cuda.max_memory_allocated() if self.cuda else 0)

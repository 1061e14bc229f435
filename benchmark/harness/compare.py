"""The comparison that decides ``correct``: each number compared, beside
its limit.

A cell's limits live in its workload file (``limits``), each set between
the largest reading of sound runs of the program against the reference
and the smallest reading of the control (the reference in the next lower
precision) or of a planted fault; ``PERF.md`` gives the readings.  A number
that is not finite fails.
"""

import math
import statistics

__all__ = ['Check', 'judge', 'leaf_gap', 'median_gap', 'median_leaf',
           'rel_gap']


class Check:
    """One number compared with its limit (``value <= limit``)."""

    def __init__(self, name, value, limit):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self):
        return math.isfinite(self.value) and self.value <= self.limit

    def as_dict(self):
        return dict(value=self.value, limit=self.limit)


def judge(values, limits):
    """Checks of ``values`` {name: number} against ``limits`` {name:
    limit}, in the limits' order; a number the run did not give fails."""
    return [Check(name, values.get(name, float('nan')), limit)
            for name, limit in limits.items()]


def rel_gap(a, b):
    """|a - b| / |b|."""
    return abs(a - b) / abs(b) if b else (0. if a == b else float('inf'))


def median_leaf(ref):
    """The index of the leaf whose reference norm is the median."""
    return sorted(range(len(ref)), key=ref.__getitem__)[len(ref) // 2]


def leaf_gap(prog, ref, skip=(), leaf=None):
    """The gap between two lists of per-leaf norms, ``|p - r|`` over the
    larger of ``r`` and the median leaf's ``r``: the worst leaf's (leaves
    whose index is in ``skip`` left out), or with ``leaf`` that leaf's."""
    med = statistics.median(ref)
    gaps = [abs(p - r) / max(r, med) if max(r, med) > 0 else abs(p - r)
            for p, r in zip(prog, ref)]
    if leaf is not None:
        return gaps[leaf]
    gaps = [g for k, g in enumerate(gaps) if k not in skip]
    return max(gaps) if gaps else 0.


def median_gap(prog, ref):
    """The median gap between two tensors of norms, item by item (such as
    each vertex's gradient): ``|p - r|`` over the larger of ``r`` and the
    median ``r``, over the items whose ``r`` is not zero.  A few items far
    off move it not at all; all of them off by a share move it by that
    share."""
    keep = ref > 0
    if not bool(keep.any()):
        return float((prog - ref).abs().max()) if prog.numel() else 0.
    p, r = prog[keep], ref[keep]
    return float(((p - r).abs() / r.clamp(min=float(r.median()))).median())

"""Clipping with ``jnp.clip``'s gradient.

``torch.clamp`` passes the whole gradient where ``x`` equals a bound;
``jnp.clip`` (``minimum(maximum(x, lo), hi)``) gives half of it to ``x``
there, as ``torch.maximum`` and ``torch.minimum`` do.  The port clips every
value that carries a gradient through :func:`clip`, so its gradients equal
the JAX package's also where a value sits exactly on a bound (a black
texel, a normal at right angles to the view).  Integer index clamps stay
``torch.clamp``.
"""

import torch

__all__ = ['clip']


def clip(x, lo=None, hi=None):
    """``min(max(x, lo), hi)`` for float bounds; ``None`` = no bound.  Each
    bound is a 0-dim tensor filled on ``x``'s device: a host-to-device copy
    would wait for the stream."""
    if lo is not None:
        x = torch.maximum(x, torch.full((), lo, dtype=x.dtype,
                                        device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.full((), hi, dtype=x.dtype,
                                        device=x.device))
    return x

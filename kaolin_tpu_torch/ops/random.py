"""Random structured test-data generators.

Port of ``kaolin_tpu/ops/random.py``.  Every helper takes an explicit
``torch.Generator`` (``generator=``); without one it draws from the module
generator, a CPU ``torch.Generator`` that :func:`manual_seed` seeds (as
``torch.manual_seed`` and a JAX key cannot give the same stream, the port's
draws are not the JAX package's).  Draws are made on the generator's device
and the results go to ``device``: one seed gives the same values on the card
and on the CPU.
"""

import math
import random as _pyrandom

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device

__all__ = [
    'manual_seed',
    'get_state',
    'set_state',
    'default_generator',
    'random_shape_per_tensor',
    'random_tensor',
    'random_spc_octrees',
    'sample_spherical_coords',
]

_GEN = torch.Generator().manual_seed(0)


def default_generator():
    """The module generator (CPU), seeded by :func:`manual_seed`."""
    return _GEN


def _gen(generator):
    return _GEN if generator is None else generator


def manual_seed(seed, random_seed=None, numpy_seed=None):
    """Seed the module generator (and python's and numpy's globals)."""
    if random_seed is None:
        random_seed = seed
    if numpy_seed is None:
        numpy_seed = seed
    _pyrandom.seed(random_seed)
    np.random.seed(numpy_seed)
    _GEN.manual_seed(seed)


def get_state():
    """The states of the module generator, python's and numpy's RNGs."""
    return _GEN.get_state(), _pyrandom.getstate(), np.random.get_state()


def set_state(state, random_state=None, numpy_state=None):
    """Restore states captured by :func:`get_state`."""
    _GEN.set_state(state)
    if random_state is not None:
        _pyrandom.setstate(random_state)
    if numpy_state is not None:
        np.random.set_state(numpy_state)


def random_shape_per_tensor(batch_size, min_shape=None, max_shape=None,
                            generator=None):
    """Random ``shape_per_tensor`` metadata (host numpy int64,
    ``(batch_size, len(max_shape))``), each dim in [min, max]."""
    if max_shape is None:
        raise ValueError("max_shape must be provided")
    max_shape = np.asarray(max_shape, dtype=np.int64)
    if min_shape is None:
        min_shape = np.ones_like(max_shape)
    else:
        min_shape = np.asarray(min_shape, dtype=np.int64)
    u = torch.rand((batch_size, max_shape.shape[0]), dtype=torch.float64,
                   generator=_gen(generator)).numpy()
    span = max_shape - min_shape + 1
    return np.minimum(min_shape + np.floor(u * span).astype(np.int64),
                      max_shape)


def random_tensor(low, high, shape, dtype=torch.float32, device=None,
                  generator=None):
    """A random tensor in [low, high] (floats: uniform in [low, high);
    integers: in [low, high]; bool: 0 or 1), on ``device`` (default the
    card)."""
    device = entry_device(device)
    gen = _gen(generator)
    shape = tuple(shape)
    if dtype.is_floating_point:
        out = torch.rand(shape, dtype=torch.float64, generator=gen,
                         device=gen.device) * (high - low) + low
    elif dtype == torch.bool:
        out = torch.randint(0, 2, shape, generator=gen, device=gen.device)
    else:
        out = torch.randint(int(low), int(high) + 1, shape, generator=gen,
                            device=gen.device)
    return out.to(device=device, dtype=dtype)


def random_spc_octrees(batch_size, max_level, dtype=torch.uint8,
                       device=None, generator=None):
    """A batch of random SPC octrees (packed bytes).

    Each node of each level gets a random non-zero occupancy byte; the next
    level has one node per set bit.

    Returns:
        (octrees, packed ``uint8`` tensor on ``device`` (default the card);
        lengths, numpy int32 bytes per octree).
    """
    device = entry_device(device)
    gen = _gen(generator)
    octrees, lengths = [], []
    for _ in range(batch_size):
        octree_length = 0
        cur_num_nodes = 1
        for _level in range(max_level):
            cur = torch.randint(1, 256, (cur_num_nodes,), generator=gen,
                                device=gen.device).cpu().numpy().astype(
                                    np.uint8)
            cur_num_nodes = int(np.unpackbits(cur[:, None], axis=1).sum())
            octrees.append(cur)
            octree_length += cur.shape[0]
        lengths.append(octree_length)
    return (torch.as_tensor(np.concatenate(octrees)).to(device=device,
                                                        dtype=dtype),
            np.asarray(lengths, dtype=np.int32))


def sample_spherical_coords(shape, azimuth_low=0., azimuth_high=math.pi * 2.,
                            elevation_low=0., elevation_high=math.pi * 0.5,
                            dtype=torch.float32, device=None,
                            generator=None):
    """Spherical coordinates uniform over the spherical cap: azimuth uniform
    in [low, high), elevation uniform in sin(elevation).

    Returns:
        (azimuth, elevation) tensors of ``shape`` on ``device`` (default the
        card).
    """
    device = entry_device(device)
    gen = _gen(generator)
    rand = torch.rand((2,) + tuple(shape), dtype=torch.float64,
                      generator=gen, device=gen.device)
    azimuth = azimuth_low + rand[0] * (azimuth_high - azimuth_low)
    sin_lo, sin_hi = math.sin(elevation_low), math.sin(elevation_high)
    elevation = torch.asin(sin_lo + rand[1] * (sin_hi - sin_lo))
    return (azimuth.to(device=device, dtype=dtype),
            elevation.to(device=device, dtype=dtype))

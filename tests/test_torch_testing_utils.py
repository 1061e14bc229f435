"""The port's checkers and printers (``utils/testing.py``) against
kaolin_tpu's, on the CPU.

Each case runs through both packages: the same return value, or the same
exception type with the same message once torch's dtype names
(``torch.float32``) are mapped to numpy's (``float32``).  Printers: the
same output after the same mapping.  ``with_seed`` restores the module
RNG state.
"""
import collections
import random
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaolin_tpu.utils import testing as TJ
from kaolin_tpu_torch.ops import random as rnd
from kaolin_tpu_torch.utils import testing as TT

DTYPES = {torch.bool: jnp.bool_, torch.uint8: jnp.uint8,
          torch.int16: jnp.int16, torch.int32: jnp.int32,
          torch.int64: jnp.int32, torch.float16: jnp.float16,
          torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _names(text):
    """Dtype names as numpy's: ``torch.float32`` and JAX's
    ``<class 'jax.numpy.float32'>`` as ``float32``."""
    text = re.sub(r"<class 'jax\.numpy\.(\w+)'>", r'\1', str(text))
    return re.sub(r'torch\.(\w+)', r'\1', text)


def _jax(x):
    """The JAX side of an argument: tensors as jnp arrays, dtypes mapped,
    containers mapped item by item."""
    if torch.is_tensor(x):
        arr = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
        return jnp.asarray(arr, dtype=DTYPES[x.dtype])
    if isinstance(x, torch.dtype):
        return DTYPES[x]
    if isinstance(x, dict):
        return {k: _jax(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return type(x)(*map(_jax, x))
    if isinstance(x, (list, tuple)):
        return type(x)(map(_jax, x))
    return x


def _outcome(fn, *args, **kwargs):
    try:
        return 'ok', fn(*args, **kwargs)
    except Exception as e:                      # compared across packages
        return type(e).__name__, _names(e)


def _both(name, /, *args, **kwargs):
    out_t = _outcome(getattr(TT, name), *args, **kwargs)
    out_j = _outcome(getattr(TJ, name), *_jax(list(args)),
                     **_jax(dict(kwargs)))
    if isinstance(out_t[1], str):
        out_t, out_j = (out_t[0], _names(out_t[1])), (out_j[0],
                                                      _names(out_j[1]))
    assert out_t == out_j, (name, out_t, out_j)
    return out_t


X = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)

CASES = [
    ('check_tensor', (X,), dict(shape=(2, 3, 4))),
    ('check_tensor', (X,), dict(shape=(2, None, 4), dtype=torch.float32)),
    ('check_tensor', (X,), dict(shape=(2, 3))),
    ('check_tensor', (X,), dict(shape=(2, 5, 4))),
    ('check_tensor', (X,), dict(shape=(2, 5, 4), throw=False)),
    ('check_tensor', (X,), dict(dtype=torch.int32)),
    ('check_tensor', (X,), dict(dtype=torch.int32, throw=False)),
    ('check_tensor', (X.half(),), dict(dtype=torch.float16)),
    ('check_packed_tensor', (X[0],), dict(total_numel=3, last_dim=4)),
    ('check_packed_tensor', (X[0],), dict(last_dim=5, throw=False)),
    ('check_padded_tensor', (X,), dict(batch_size=2, max_shape=(3,),
                                       last_dim=4)),
    ('check_padded_tensor', (torch.zeros(2, 3, 2),),
     dict(padding_value=0., shape_per_tensor=torch.tensor([[1], [3]]))),
    ('check_padded_tensor', (torch.ones(2, 3, 2),),
     dict(padding_value=0., shape_per_tensor=torch.tensor([[1], [3]]))),
    ('check_padded_tensor', (torch.ones(2, 3, 2),),
     dict(padding_value=0., shape_per_tensor=torch.tensor([[1], [3]]),
          throw=False)),
    ('check_padded_tensor', (X,), dict(dtype=torch.int32)),
    ('check_spc_octrees', (torch.tensor([1, 3, 255, 1], dtype=torch.uint8),
                           torch.tensor([2, 2])), dict(level=2)),
    ('check_spc_octrees', (torch.tensor([1, 3, 255, 1], dtype=torch.uint8),
                           torch.tensor([2, 2])), dict(level=3)),
    ('check_spc_octrees', (torch.tensor([3, 1, 1], dtype=torch.uint8),
                           torch.tensor([3])), {}),
    ('check_spc_octrees', (torch.tensor([1, 3], dtype=torch.int32),
                           torch.tensor([2])), {}),
    ('check_spc_octrees', (torch.tensor([1, 3], dtype=torch.uint8),
                           torch.tensor([2])), dict(batch_size=2)),
    ('check_spc_octrees', (torch.tensor([1, 3], dtype=torch.uint8),
                           torch.tensor([3])), dict(throw=False)),
    ('tensor_info', (X,), dict(name='x')),
    ('tensor_info', (X,), dict(name='x', print_stats=True)),
    ('tensor_info', (X.int(),), dict(name='i', detailed=True)),
    ('tensor_info', (None,), dict(name='n')),
    ('tensor_info', (torch.tensor([True, False]),), dict(print_stats=True)),
    ('contained_allclose', ({'a': X, 'b': [X[0], 'c', None]},
                            {'a': X + 1e-7, 'b': [X[0], 'c', None]}), {}),
    ('contained_allclose', ({'a': X}, {'a': X + 1.}), {}),
    ('contained_allclose', ([X, 1], [X, 1.0]), {}),
    ('contained_allclose', ({'a': X}, {'b': X}), {}),
    ('contained_equal', ((X, {'k': X.int()}), (X, {'k': X.int()})), {}),
    ('contained_equal', ((X,), (X + 1e-7,)), {}),
    ('contained_equal', ((X,), (X + 1e-7,)), dict(approximate=True)),
    ('contained_equal', ([X], [X, X]), {}),
    ('check_allclose', (X, X + 1e-7), {}),
    ('check_allclose', (X, X + 1.), {}),
    ('check_tensor_attribute_shapes', ({'a': X, 'b': X[0]},),
     dict(a=(2, 3, 4), b=(3, None))),
    ('check_tensor_attribute_shapes', ({'a': X},), dict(a=(2, 2, 4))),
    ('check_tensor_attribute_shapes', ({'a': X},),
     dict(a=(2, 2, 4), throw=False)),
]


@pytest.mark.parametrize('i', range(len(CASES)),
                         ids=[f'{c[0]}-{i}' for i, c in enumerate(CASES)])
def test_checkers(i):
    name, args, kwargs = CASES[i]
    out = _both(name, *args, **kwargs)
    if name == 'tensor_info':
        assert out[1] is not None


def test_contained_equal_namedtuple():
    Pair = collections.namedtuple('Pair', 'x y')
    _both('contained_equal', Pair(X, 'a'), Pair(X, 'a'))
    _both('contained_equal', Pair(X, 'a'), Pair(X + 1, 'a'))


def test_dtype_lists():
    for name in ('BOOL_DTYPES', 'INT_DTYPES', 'FLOAT_DTYPES', 'NUM_DTYPES',
                 'ALL_DTYPES'):
        assert [DTYPES[d] for d in getattr(TT, name)] == getattr(TJ, name)


def test_printers(capsys):
    Pair = collections.namedtuple('Pair', 'x y')
    d = {'x': X, 'n': 3, 's': 'str', 'l': [1, 2], 'sub': {'y': X[0]},
         'o': object}
    for fn, arg in (('print_dict_attributes', d),
                    ('print_namedtuple_attributes', Pair(X, 'a'))):
        getattr(TT, fn)(arg, name='thing', print_stats=True)
        out_t = capsys.readouterr().out
        getattr(TJ, fn)(_jax(arg), name='thing', print_stats=True)
        out_j = capsys.readouterr().out
        assert _names(out_t) == _names(out_j)


def test_with_seed_restores_state():
    rnd.manual_seed(123)
    before = (rnd.get_state()[0].clone(), random.getstate(),
              np.random.get_state()[1].copy())

    @TT.with_seed(7)
    def draw():
        return (rnd.random_tensor(0., 1., (4,), device='cpu'),
                random.random(), np.random.rand())

    first, second = draw(), draw()
    assert torch.equal(first[0], second[0]) and first[1:] == second[1:]
    assert torch.equal(rnd.get_state()[0], before[0])
    assert random.getstate() == before[1]
    np.testing.assert_array_equal(np.random.get_state()[1], before[2])

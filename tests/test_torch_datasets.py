"""The port's datasets against kaolin_tpu's, on the CPU.

ShapeNetV1 / V2, ModelNet and SHREC16 over small trees written into
``tmp_path`` (``utils/testing.py``'s writers: deformed ``uv_sphere(20,
11)`` models): the same paths, attributes, labels and mesh arrays.
``CachedDataset`` in every mode (disk fields, RAM fields, reuse without
recompute, ``force_overwrite``, ``cache_at_runtime``, cleanup on a failing
getter, 2 spawned workers), each against the JAX class on the same base
dataset; the cache files read across packages; ``Cache``,
``ProcessedDataset``, ``CombinationDataset``, ``KaolinDataset``; a
``DataLoader``; the ShapeNet ``transform`` divergence.  Limits: exact.
"""
import os
import warnings

import numpy as np
import pytest
import torch

from kaolin_tpu.io import dataset as dj
from kaolin_tpu.io import modelnet as mnj
from kaolin_tpu.io import shapenet as snj
from kaolin_tpu.io import shrec as shj
from kaolin_tpu_torch.io import dataset as dt
from kaolin_tpu_torch.io import modelnet as mnt
from kaolin_tpu_torch.io import shapenet as snt
from kaolin_tpu_torch.io import shrec as sht
from kaolin_tpu_torch.utils.testing import (
    CountedDataset, deformed_sphere, mesh_arrays, write_modelnet,
    write_shapenet_v2, write_shrec16, write_sphere_obj)

SYNSETS = ('02691156', '03001627')
SPHERE = (12, 7)

pytestmark = pytest.mark.filterwarnings('ignore::DeprecationWarning')


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp('trees')
    write_shapenet_v2(str(root / 'v2'), SYNSETS, 3, SPHERE)
    for i, syn in enumerate(SYNSETS):           # V1: {synset}/{model}/model.obj
        for m in range(2):
            d = root / 'v1' / syn / f'm{m}'
            d.mkdir(parents=True)
            os.replace(write_sphere_obj(str(d), deformed_sphere(
                50 + 2 * i + m, SPHERE)), d / 'model.obj')
    write_modelnet(str(root / 'mn'), ['bed', 'chair'], 2, SPHERE)
    write_shrec16(str(root / 'sh'), SYNSETS, 2, SPHERE)
    return root


def _same_mesh(a, b):
    for k in ('vertices', 'faces', 'uvs', 'face_uvs_idx'):
        va, vb = getattr(a, k, None), getattr(b, k, None)
        assert (va is None) == (vb is None), k
        if va is not None:
            np.testing.assert_array_equal(np.asarray(va), vb.numpy(), k)


def _same_items(ds_j, ds_t):
    assert len(ds_j) == len(ds_t) > 0
    for i in range(len(ds_j)):
        a, b = ds_j[i], ds_t[i]
        mesh_a, mesh_b = a.pop('mesh'), b.pop('mesh')
        assert a == b
        _same_mesh(mesh_a, mesh_b)
        assert mesh_b.vertices.device.type == 'cpu'


@pytest.mark.parametrize('version,train', [('V1', True), ('V2', True),
                                           ('V2', False)])
def test_shapenet(trees, version, train):
    sub = 'v1' if version == 'V1' else 'v2'
    kw = dict(root=str(trees / sub), train=train, split=0.67)
    ds_j = getattr(snj, f'ShapeNet{version}')(**kw)
    ds_t = getattr(snt, f'ShapeNet{version}')(**kw, device='cpu')
    assert [str(p) for p in ds_j.paths] == [str(p) for p in ds_t.paths]
    assert ds_j.synset_idxs == ds_t.synset_idxs
    _same_items(ds_j, ds_t)


def test_shapenet_categories_and_labels(trees):
    assert snt.synset_to_labels == snj.synset_to_labels
    assert snt.labels_to_synset == snj.labels_to_synset
    kw = dict(root=str(trees / 'v2'), categories=['chair'])
    ds_t = snt.ShapeNetV2(**kw, device='cpu')
    assert ds_t.synsets == snj.ShapeNetV2(**kw).synsets == ['03001627']
    with pytest.raises(ValueError, match='not a valid ShapeNet'):
        snt.ShapeNetV2(str(trees / 'v2'), categories=['nope'], device='cpu')


def test_modelnet_and_shrec(trees):
    for cat in (None, ['chair']):
        ds_j = mnj.ModelNet(str(trees / 'mn'), categories=cat)
        ds_t = mnt.ModelNet(str(trees / 'mn'), categories=cat, device='cpu')
        assert ds_j.labels == ds_t.labels
        _same_items(ds_j, ds_t)
    ds_j = shj.SHREC16(str(trees / 'sh'))
    ds_t = sht.SHREC16(str(trees / 'sh'), device='cpu')
    _same_items(ds_j, ds_t)
    with pytest.raises(AssertionError, match='Split'):
        mnt.ModelNet(str(trees / 'mn'), split='val', device='cpu')


def test_shapenet_applies_transform(trees):
    """The port applies ``transform`` (as ModelNet and SHREC16 do); the JAX
    ShapeNet ignores it."""
    def tag(item):
        return {**item, 'tagged': True}
    kw = dict(root=str(trees / 'v2'), transform=tag)
    assert snt.ShapeNetV2(**kw, device='cpu')[0]['tagged']
    assert 'tagged' not in snj.ShapeNetV2(**kw)[0]
    assert mnt.ModelNet(str(trees / 'mn'), transform=tag,
                        device='cpu')[0]['tagged']


class Items:
    """A base dataset of numpy fields (module level: picklable)."""

    def __init__(self, n=4, offset=0., fail_at=None):
        self.n, self.offset, self.fail_at = n, offset, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise RuntimeError(f'item {i} fails')
        rng = np.random.default_rng(i)
        return {'a': (rng.random((3, 2)) + self.offset).astype(np.float32),
                'b': np.arange(i + 2, dtype=np.int64),
                'c': rng.integers(0, 9, (4,)).astype(np.int32)}


def _equal(item_j, item_t):
    assert sorted(item_j) == sorted(item_t)
    for k in item_j:
        np.testing.assert_array_equal(np.asarray(item_j[k]),
                                      np.asarray(item_t[k]), k)


MODES = {
    'ram': dict(save_on_disk=False),
    'disk': dict(save_on_disk=True),
    'fields': dict(save_on_disk=['a', 'c']),
    'runtime': dict(save_on_disk=['b'], cache_at_runtime=True),
    'transform': dict(save_on_disk=True,
                      transform=lambda d: {**d, 'a': d['a'] * 2}),
}


@pytest.mark.parametrize('mode', list(MODES))
def test_cached_dataset_modes(tmp_path, mode):
    kw = MODES[mode]
    cj = dj.CachedDataset(Items(), str(tmp_path / 'j'), **kw)
    ct = dt.CachedDataset(Items(), str(tmp_path / 't'), device='cpu', **kw)
    assert len(cj) == len(ct) == 4
    assert cj.on_disk == ct.on_disk
    for i in range(4):
        _equal(cj[i], ct[i])
    for k in ct.on_disk:
        assert (tmp_path / 't' / '3' / f'{k}.npz').exists()
        assert torch.is_tensor(ct[0][k]) and ct[0][k].device.type == 'cpu'


def test_cached_dataset_reuse_and_overwrite(tmp_path):
    log = str(tmp_path / 'calls')
    d = str(tmp_path / 'cache')
    dt.CachedDataset(CountedDataset(Items(), log + '0'), d,
                     save_on_disk=True, device='cpu')
    assert CountedDataset.calls(log + '0') == 5          # probe + 4 items
    path = tmp_path / 'cache' / '2' / 'a.npz'
    stamp = path.stat().st_mtime_ns
    warm = dt.CachedDataset(CountedDataset(Items(offset=1.), log + '1'), d,
                            save_on_disk=True, device='cpu')
    assert CountedDataset.calls(log + '1') == 1           # the probe only
    assert path.stat().st_mtime_ns == stamp
    _equal(warm[2], Items()[2])                           # the old values
    # a list of fields: the getter runs for the RAM field, the disk field
    # is not rewritten
    part = dt.CachedDataset(Items(offset=1.), d, save_on_disk=['a'],
                            device='cpu')
    assert path.stat().st_mtime_ns == stamp
    np.testing.assert_array_equal(part[2]['a'], Items()[2]['a'])
    forced = dt.CachedDataset(Items(offset=1.), d, save_on_disk=True,
                              force_overwrite=True, device='cpu')
    np.testing.assert_array_equal(forced[2]['a'], Items(offset=1.)[2]['a'])
    jax_forced = dj.CachedDataset(Items(offset=1.), str(tmp_path / 'j'),
                                  save_on_disk=True, force_overwrite=True)
    _equal(jax_forced[2], forced[2])


class Renamed(Items):
    """Items whose field 'c' became 'd' (module level: picklable)."""

    def __getitem__(self, i):
        out = super().__getitem__(i)
        out['d'] = out.pop('c') + 1
        return out


def test_cached_dataset_fields_change(tmp_path):
    """A getter whose fields changed since the cache was written: the new
    field is computed, the dropped one is not served, as in JAX."""
    out = {}
    for pkg, d in ((dj, tmp_path / 'j'), (dt, tmp_path / 't')):
        kw = {} if pkg is dj else dict(device='cpu')
        pkg.CachedDataset(Items(), str(d), save_on_disk=True, **kw)
        out[pkg] = pkg.CachedDataset(Renamed(offset=1.), str(d),
                                     save_on_disk=True, **kw)
    assert out[dt].on_disk == out[dj].on_disk == {'a', 'b', 'd'}
    for i in range(4):
        _equal(out[dj][i], out[dt][i])
        np.testing.assert_array_equal(out[dt][i]['d'], Renamed()[i]['d'])
        np.testing.assert_array_equal(out[dt][i]['a'], Items()[i]['a'])


def test_cached_dataset_runtime_calls(tmp_path):
    log = str(tmp_path / 'calls')
    ct = dt.CachedDataset(CountedDataset(Items(), log), str(tmp_path / 'c'),
                          save_on_disk=['a'], cache_at_runtime=True,
                          device='cpu')
    assert CountedDataset.calls(log) == 0
    ct[1]
    ct[1]
    assert CountedDataset.calls(log) == 1


def test_cached_dataset_cleans_up_on_failure(tmp_path):
    for pkg, d in ((dj, tmp_path / 'j'), (dt, tmp_path / 't')):
        kw = {} if pkg is dj else dict(device='cpu')
        with pytest.raises(RuntimeError, match='item 2 fails'):
            pkg.CachedDataset(Items(fail_at=2), str(d), save_on_disk=['a'],
                              **kw)
        assert not list(d.rglob('*.npz'))


def test_cached_dataset_spawned_workers(trees, tmp_path):
    base = dt.ProcessedDataset(snt.ShapeNetV2(str(trees / 'v2'),
                                              device='cpu'), mesh_arrays)
    log = str(tmp_path / 'calls')
    two = dt.CachedDataset(CountedDataset(base, log), str(tmp_path / 'w'),
                           save_on_disk=['vertices', 'faces'], num_workers=2,
                           device='cpu')
    one = dt.CachedDataset(base, str(tmp_path / 'z'),
                           save_on_disk=['vertices', 'faces'], device='cpu')
    assert CountedDataset.calls(log) == len(base)    # in the workers
    for i in range(len(base)):
        _equal(two[i], one[i])


def test_caches_read_across_packages(tmp_path):
    dj.CachedDataset(Items(), str(tmp_path / 'j'), save_on_disk=True)
    dt.CachedDataset(Items(), str(tmp_path / 't'), save_on_disk=True,
                     device='cpu')
    from_j = dt.CachedDataset(Items(offset=5.), str(tmp_path / 'j'),
                              save_on_disk=True, device='cpu')
    from_t = dj.CachedDataset(Items(offset=5.), str(tmp_path / 't'),
                              save_on_disk=True)
    for i in range(4):
        _equal(from_j[i], Items()[i])
        _equal(from_t[i], Items()[i])


def test_cache(tmp_path):
    calls = []

    def func(x):
        calls.append(x)
        return {'y': np.full((2,), x, np.float32)}
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        cj = dj.Cache(func, str(tmp_path), 'k')
        first = cj('id0', x=3.)
        ct = dt.Cache(func, str(tmp_path), 'k', device='cpu')
        again = ct('id0', x=4.)                    # read from the JAX file
        new = ct('id1', x=5.)
        back = dj.Cache(func, str(tmp_path), 'k')('id1', x=6.)
    assert calls == [3., 5.]
    np.testing.assert_array_equal(np.asarray(first['y']), again['y'].numpy())
    np.testing.assert_array_equal(np.asarray(back['y']), new['y'])


class _Kaolin:
    def initialize(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_data(self, i):
        return np.arange(i + 1)

    def get_attributes(self, i):
        return {'name': f'item{i}'}


class KJ(_Kaolin, dj.KaolinDataset):
    pass


class KT(_Kaolin, dt.KaolinDataset):
    pass


def test_processed_combination_kaolin():
    pj = dj.ProcessedDataset(Items(), lambda d: {'s': d['a'].sum()})
    pt = dt.ProcessedDataset(Items(), lambda d: {'s': d['a'].sum()})
    assert [pj[i] for i in range(4)] == [pt[i] for i in range(4)]
    cj = dj.CombinationDataset([Items(), pj])
    ct = dt.CombinationDataset([Items(), pt])
    assert len(cj) == len(ct) == 4
    _equal(cj[1][0], ct[1][0])
    assert cj[1][1] == ct[1][1]
    with pytest.raises(AssertionError):
        dt.CombinationDataset([Items(3), Items(4)])
    kj, kt = KJ(3), KT(3)
    assert isinstance(kt, torch.utils.data.Dataset)
    for i in range(3):
        assert kj[i]['attributes'] == kt[i]['attributes']
        np.testing.assert_array_equal(kj[i]['data'], kt[i]['data'])


def test_dataloader_over_the_port(trees, tmp_path):
    base = dt.ProcessedDataset(snt.ShapeNetV2(str(trees / 'v2'),
                                              device='cpu'), mesh_arrays)
    cache = dt.CachedDataset(base, str(tmp_path / 'c'), save_on_disk=True,
                             device='cpu')
    loader = torch.utils.data.DataLoader(cache, batch_size=2)
    batches = list(loader)
    assert len(batches) == 2
    v = torch.cat([b['vertices'] for b in batches])
    ref = snj.ShapeNetV2(str(trees / 'v2'))
    np.testing.assert_array_equal(
        v.numpy(), np.stack([np.asarray(ref[i]['mesh'].vertices)
                             for i in range(len(ref))]))

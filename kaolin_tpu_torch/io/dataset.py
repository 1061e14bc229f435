"""Dataset wrappers with preprocessing and caching.

Port of ``kaolin_tpu/io/dataset.py``.  Every dataset is a
``torch.utils.data.Dataset``, so a ``DataLoader`` takes it.  Disk caching
writes one ``np.savez`` file per field, ``{cache_dir}/{idx}/{key}.npz``
with the array under ``value``: the JAX package's layout, so each package
reads the other's caches.

Preprocessing workers run in a ``spawn`` context: CUDA cannot start in a
forked child, and a getter may put its outputs on the card.  What the
workers call (the base dataset's ``__getitem__``, a transform) must pickle:
module-level functions and classes.
"""

import multiprocessing
import warnings
from pathlib import Path

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['Dataset', 'CachedDataset', 'Cache', 'KaolinDataset',
           'ProcessedDataset', 'CombinationDataset']


class Dataset(torch.utils.data.Dataset):
    """Map-style dataset: ``__len__`` and ``__getitem__``."""

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError


def _field_path(cache_dir, idx, key):
    return Path(cache_dir) / str(idx) / f'{key}.npz'


def _numpy(value):
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _save_field(cache_dir, idx, key, value):
    path = _field_path(cache_dir, idx, key)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, value=_numpy(value))


def _load_field(cache_dir, idx, key, device):
    with np.load(_field_path(cache_dir, idx, key)) as data:
        return torch.as_tensor(data['value'], device=device)


def _save_task(args):
    cache_dir, idx, getter, to_save_on_disk, to_not_save = args
    out = getter(idx)
    kept = {}
    for k, v in out.items():
        if k in to_save_on_disk:
            _save_field(cache_dir, idx, k, v)
        elif k not in to_not_save:
            kept[k] = v
    return kept


class CachedDataset(Dataset):
    """Cache a base dataset's outputs to RAM and/or disk.

    Same arguments and semantics as the JAX package's ``CachedDataset``, plus
    ``device``: where the fields read from disk go (default: the card, see
    :func:`~kaolin_tpu_torch._device.entry_device`); fields kept in RAM are
    the base dataset's own.

    Args:
        dataset: base dataset / sequence yielding dicts of arrays.
        cache_dir: where to store on-disk fields.
        save_on_disk: True (all fields), False (all to RAM), or a sequence
            of field names to put on disk.
        num_workers: parallel preprocessing processes (0 = main process),
            started with ``spawn``.
        force_overwrite: overwrite existing cache files.
        cache_at_runtime: lazily cache at first access instead of eagerly.
        progress_message: printed during eager preprocessing.
        transform: applied to items at access time (not cached).
        device: where the fields read from disk go.

    With ``save_on_disk=True`` the fields are those of ``dataset[0]``, as
    in the JAX package; when every one of them is already on disk for every
    item (``force_overwrite`` False), that probe is the only call of the
    base getter.  (The JAX package then calls it once per item as well, and
    drops what it returns.)
    """

    def __init__(self, dataset, cache_dir=None, save_on_disk=False,
                 num_workers=0, force_overwrite=False,
                 cache_at_runtime=False, progress_message=None,
                 ignore_diff_error=False, transform=None, device=None):
        self.size = len(dataset)
        self.transform = transform
        self.device = entry_device(device)
        self.cache_dir = None if cache_dir is None else Path(cache_dir)

        if save_on_disk is True:
            probe = dataset[0]
            self.to_save_on_disk = set(probe.keys())
        elif save_on_disk is False:
            self.to_save_on_disk = set()
        else:
            self.to_save_on_disk = set(save_on_disk)
        if self.to_save_on_disk and self.cache_dir is None:
            raise ValueError(
                "cache_dir must be given when save_on_disk is set")

        # fields already on disk from a previous run are not recomputed
        self.to_not_save = set()
        if self.cache_dir is not None and not force_overwrite:
            existing = {
                k for k in self.to_save_on_disk
                if all(_field_path(self.cache_dir, i, k).exists()
                       for i in range(self.size))}
            self.to_not_save = existing
            self.to_save_on_disk -= existing
        self.on_disk = self.to_save_on_disk | self.to_not_save
        # nothing left to compute: every field is on disk
        all_cached = save_on_disk is True and not self.to_save_on_disk

        if cache_at_runtime:
            self.data = [{} if all_cached else None] * self.size
            self.dataset = dataset
        elif all_cached:
            self.data = [{} for _ in range(self.size)]
        else:
            self.data = []
            try:
                tasks = [(self.cache_dir, i, dataset.__getitem__,
                          self.to_save_on_disk, self.on_disk)
                         for i in range(self.size)]
                if num_workers > 0:
                    ctx = multiprocessing.get_context('spawn')
                    with ctx.Pool(num_workers) as p:
                        for i, out in enumerate(p.imap(_save_task, tasks)):
                            if progress_message:
                                print(f'\r{progress_message} '
                                      f'{i + 1}/{self.size}', end='')
                            self.data.append(out)
                else:
                    for i, t in enumerate(tasks):
                        if progress_message:
                            print(f'\r{progress_message} '
                                  f'{i + 1}/{self.size}', end='')
                        self.data.append(_save_task(t))
                if progress_message:
                    print()
            except Exception:
                self._clean_cache_dir()
                raise

    def _clean_cache_dir(self):
        """Remove the cache files this run generated, on a failure."""
        if self.cache_dir is None:
            return
        for k in self.to_save_on_disk:
            for i in range(self.size):
                p = _field_path(self.cache_dir, i, k)
                if p.exists():
                    p.unlink()

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        if self.data[index] is None:  # cache_at_runtime
            self.data[index] = _save_task(
                (self.cache_dir, index, self.dataset.__getitem__,
                 self.to_save_on_disk, self.on_disk))
        out = dict(self.data[index])
        for k in self.on_disk:
            out[k] = _load_field(self.cache_dir, index, k, self.device)
        if self.transform is not None:
            out = self.transform(out)
        return out


class Cache:
    """Deprecated callable-result cache; results come back on ``device``
    (default: the card)."""

    def __init__(self, func, cache_dir, cache_key, device=None):
        warnings.warn("Cache is deprecated, use CachedDataset",
                      DeprecationWarning)
        self.func = func
        self.device = entry_device(device)
        self.cache_dir = Path(cache_dir)
        self.cache_key = cache_key
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.cached_ids = {
            p.stem for p in self.cache_dir.glob('*.npz')}

    def __call__(self, unique_id, **kwargs):
        path = self.cache_dir / f'{unique_id}.npz'
        if unique_id in self.cached_ids and path.exists():
            with np.load(path, allow_pickle=True) as data:
                return {k: torch.as_tensor(v, device=self.device)
                        for k, v in data.items()}
        out = self.func(**kwargs)
        np.savez(path, **{k: _numpy(v) for k, v in out.items()})
        self.cached_ids.add(unique_id)
        return out


class KaolinDataset(Dataset):
    """Deprecated split-initialize base dataset."""

    def __init__(self, *args, **kwargs):
        warnings.warn("KaolinDataset is deprecated, use CachedDataset",
                      DeprecationWarning)
        self.initialize(*args, **kwargs)

    def initialize(self, *args, **kwargs):
        raise NotImplementedError

    def __getitem__(self, index):
        attributes = self.get_attributes(index)
        data = self.get_data(index)
        return {'data': data, 'attributes': attributes}

    def get_data(self, index):
        raise NotImplementedError

    def get_attributes(self, index):
        raise NotImplementedError


class ProcessedDataset(Dataset):
    """Deprecated eager-preprocessing wrapper."""

    def __init__(self, dataset, preprocessing_transform=None):
        warnings.warn("ProcessedDataset is deprecated, use CachedDataset",
                      DeprecationWarning)
        self.dataset = dataset
        self.transform = preprocessing_transform

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        out = self.dataset[index]
        if self.transform is not None:
            out = self.transform(out)
        return out


class CombinationDataset(Dataset):
    """Zip multiple datasets of the same length."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.size = len(datasets[0])
        for d in datasets:
            assert len(d) == self.size, \
                "all datasets must have the same length"

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        return tuple(d[index] for d in self.datasets)

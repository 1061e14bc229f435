"""SHREC16 dataset wrapper.

Port of ``kaolin_tpu/io/shrec.py`` ("Large-scale 3D shape retrieval from
ShapeNet Core55" challenge layout): the same path order and attributes,
over the port's OBJ importer.
"""

import os
import warnings
from pathlib import Path

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.io import obj as obj_io
from kaolin_tpu_torch.io.dataset import Dataset
from kaolin_tpu_torch.io.shapenet import synset_to_labels, labels_to_synset

__all__ = ['SHREC16']


def _convert_categories(categories):
    if categories is None:
        return None
    out = []
    for c in categories:
        if c in synset_to_labels:
            out.append(c)
        elif c in labels_to_synset:
            out.append(labels_to_synset[c])
        else:
            raise ValueError(
                f"Category {c!r} is not a valid SHREC16 synset or label")
    return out


class SHREC16(Dataset):
    """SHREC16 (.obj) mesh dataset; meshes on ``device`` (default: the
    card).  Layout: ``root/{split}/{synset}/*.obj`` with splits
    train/val/test.
    """

    def __init__(self, root, categories=None, split='train',
                 transform=None, output_dict=True, device=None):
        assert split in ['train', 'val', 'test'], \
            f'Split must be train, val or test, but got {split}.'
        self.root = Path(root)
        self.transform = transform
        self.output_dict = output_dict
        self.device = entry_device(device)
        synsets = _convert_categories(categories)
        split_dir = self.root / split
        if synsets is None:
            synsets = sorted(
                p for p in os.listdir(split_dir)
                if os.path.isdir(split_dir / p))
        self.synsets = synsets
        self.paths = []
        self.synset_idxs = []
        for i, syn in enumerate(synsets):
            syn_dir = split_dir / syn
            if not syn_dir.exists():
                warnings.warn(f'synset dir {syn_dir} missing, skipping')
                continue
            for f in sorted(os.listdir(syn_dir)):
                if f.endswith('.obj'):
                    self.paths.append(syn_dir / f)
                    self.synset_idxs.append(i)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        path = self.paths[index]
        mesh = obj_io.import_mesh(
            str(path), error_handler=obj_io.skip_error_handler,
            triangulate=True, device=self.device)
        synset = self.synsets[self.synset_idxs[index]]
        attributes = {
            'name': path.stem,
            'path': str(path),
            'synset': synset,
            'labels': synset_to_labels.get(synset, [synset]),
        }
        out = {'mesh': mesh, **attributes} if self.output_dict else \
            {'data': mesh, 'attributes': attributes}
        if self.transform is not None:
            out = self.transform(out)
        return out

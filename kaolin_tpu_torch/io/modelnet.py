"""ModelNet dataset wrapper.

Port of ``kaolin_tpu/io/modelnet.py``: the same layout, path order and
attributes, over the port's OFF importer.
"""

import os
from pathlib import Path

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.io import off as off_io
from kaolin_tpu_torch.io.dataset import Dataset

__all__ = ['ModelNet']


class ModelNet(Dataset):
    """ModelNet (.off) mesh dataset; meshes on ``device`` (default: the
    card).  Layout: ``root/{category}/{split}/*.off``.
    """

    def __init__(self, root, categories=None, split='train', transform=None,
                 output_dict=True, device=None):
        assert split in ['train', 'test'], \
            f'Split must be either train or test, but got {split}.'
        if not os.path.exists(root):
            raise ValueError(f'ModelNet was not found at "{root}".')
        self.root = Path(root)
        self.transform = transform
        self.output_dict = output_dict
        self.device = entry_device(device)
        self.paths = []
        self.labels = []
        all_categories = sorted(
            p for p in os.listdir(root)
            if os.path.isdir(os.path.join(root, p)))
        if categories is None:
            categories = all_categories
        for category in categories:
            assert category in all_categories, \
                f'Object class {category} not in list of available ' \
                f'classes: {all_categories}'
            cat_dir = self.root / category / split
            for f in sorted(os.listdir(cat_dir)):
                if f.endswith('.off'):
                    self.paths.append(cat_dir / f)
                    self.labels.append(category)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        path = self.paths[index]
        mesh = off_io.import_mesh(str(path), device=self.device)
        attributes = {
            'name': path.stem,
            'path': str(path),
            'label': self.labels[index],
        }
        out = {'mesh': mesh, **attributes} if self.output_dict else \
            {'data': mesh, 'attributes': attributes}
        if self.transform is not None:
            out = self.transform(out)
        return out

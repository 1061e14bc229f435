"""ShapeNet dataset wrappers.

Port of ``kaolin_tpu/io/shapenet.py``: the same directory layouts, path
order, splits and attributes, over the port's OBJ importer.  Expects the
standard ShapeNetCore layouts:

* V1: ``root/{synset}/{model}/model.obj``
* V2: ``root/{synset}/{model}/models/model_normalized.obj``

Unlike the JAX package, ``__getitem__`` applies ``transform`` (as ModelNet
and SHREC16 do in both packages).
"""

import os
from pathlib import Path

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.io import obj as obj_io
from kaolin_tpu_torch.io.dataset import Dataset

__all__ = ['ShapeNetV1', 'ShapeNetV2', 'synset_to_labels',
           'labels_to_synset']

# standard ShapeNetCore (55) synset -> label mapping (public taxonomy)
synset_to_labels = {
    '02691156': ['airplane,aeroplane,plane'],
    '02747177': ['ashcan,trash can,garbage can,wastebin'],
    '02773838': ['bag,traveling bag,travelling bag,grip,suitcase'],
    '02801938': ['basket,handbasket'],
    '02808440': ['bathtub,bathing tub,bath,tub'],
    '02818832': ['bed'],
    '02828884': ['bench'],
    '02834778': ['bicycle,bike,wheel,cycle'],
    '02843684': ['birdhouse'],
    '02871439': ['bookshelf'],
    '02876657': ['bottle'],
    '02880940': ['bowl'],
    '02924116': ['bus,autobus,coach'],
    '02933112': ['cabinet'],
    '02942699': ['camera,photographic camera'],
    '02946921': ['can,tin,tin can'],
    '02954340': ['cap'],
    '02958343': ['car,auto,automobile,machine,motorcar'],
    '02992529': ['cellular telephone,cellular phone,cellphone'],
    '03001627': ['chair'],
    '03046257': ['clock'],
    '03085013': ['computer keyboard,keypad'],
    '03207941': ['dishwasher,dish washer,dishwashing machine'],
    '03211117': ['display,video display'],
    '03261776': ['earphone,earpiece,headphone,phone'],
    '03325088': ['faucet,spigot'],
    '03337140': ['file,file cabinet,filing cabinet'],
    '03467517': ['guitar'],
    '03513137': ['helmet'],
    '03593526': ['jar'],
    '03624134': ['knife'],
    '03636649': ['lamp'],
    '03642806': ['laptop,laptop computer'],
    '03691459': ['loudspeaker,speaker,speaker unit'],
    '03710193': ['mailbox,letter box'],
    '03759954': ['microphone,mike'],
    '03761084': ['microwave,microwave oven'],
    '03790512': ['motorcycle,bike'],
    '03797390': ['mug'],
    '03928116': ['piano,pianoforte,forte-piano'],
    '03938244': ['pillow'],
    '03948459': ['pistol,handgun,side arm,shooting iron'],
    '03991062': ['pot,flowerpot'],
    '04004475': ['printer,printing machine'],
    '04074963': ['remote control,remote'],
    '04090263': ['rifle'],
    '04099429': ['rocket,projectile'],
    '04225987': ['skateboard'],
    '04256520': ['sofa,couch,lounge'],
    '04330267': ['stove'],
    '04379243': ['table'],
    '04401088': ['telephone,phone,telephone set'],
    '04460130': ['tower'],
    '04468005': ['train,railroad train'],
    '04530566': ['vessel,watercraft'],
    '04554684': ['washer,automatic washer,washing machine'],
}
labels_to_synset = {}
for _synset, _labels in synset_to_labels.items():
    for _ll in _labels[0].split(','):
        labels_to_synset[_ll] = _synset



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
            raise ValueError(f"Category {c!r} is not a valid ShapeNet "
                             f"synset or label")
    return out


class _ShapeNetBase(Dataset):
    MODEL_REL_PATH = None

    def __init__(self, root, categories=None, train=True, split=0.7,
                 with_materials=True, transform=None, output_dict=True,
                 device=None):
        self.root = Path(root)
        self.transform = transform
        self.output_dict = output_dict
        self.with_materials = with_materials
        self.device = entry_device(device)
        synsets = _convert_categories(categories)
        if synsets is None:
            synsets = sorted(
                p for p in os.listdir(root)
                if os.path.isdir(os.path.join(root, p)))
        self.synsets = synsets
        self.paths = []
        self.synset_idxs = []
        for i, syn in enumerate(synsets):
            syn_dir = self.root / syn
            models = sorted(
                p for p in os.listdir(syn_dir)
                if os.path.isdir(syn_dir / p))
            split_idx = int(len(models) * split)
            models = models[:split_idx] if train else models[split_idx:]
            for m in models:
                self.paths.append(syn_dir / m / self.MODEL_REL_PATH)
                self.synset_idxs.append(i)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        path = self.paths[index]
        mesh = obj_io.import_mesh(
            str(path), with_materials=self.with_materials,
            error_handler=obj_io.skip_error_handler,
            heterogeneous_mesh_handler=None, triangulate=True,
            device=self.device)
        synset = self.synsets[self.synset_idxs[index]]
        attributes = {
            'name': path.parent.name,
            'path': str(path),
            'synset': synset,
            'labels': synset_to_labels.get(synset, [synset]),
        }
        out = {'mesh': mesh, **attributes} if self.output_dict else \
            {'data': mesh, 'attributes': attributes}
        if self.transform is not None:
            out = self.transform(out)
        return out


class ShapeNetV1(_ShapeNetBase):
    """ShapeNet V1 mesh dataset; meshes on ``device`` (default: the
    card)."""
    MODEL_REL_PATH = 'model.obj'


class ShapeNetV2(_ShapeNetBase):
    """ShapeNet V2 mesh dataset; meshes on ``device`` (default: the
    card)."""
    MODEL_REL_PATH = os.path.join('models', 'model_normalized.obj')

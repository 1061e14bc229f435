"""The plain reference against the program's plain CPU path, through the
drivers at small sizes: every number compared within its cell's limit."""

import pytest
import torch

from conftest import drive, small_dibr, small_spc
from benchmark.reference import spc as ref_spc


@pytest.mark.parametrize('cell', ['dibr.sphere10k.512x4',
                                  'dibr.sphere40k.512x4'])
def test_dibr_reference_matches_plain_path(cell):
    config, w = small_dibr(cell)
    out = drive(config, w)
    assert out.attempted > 0 and out.failed == 0
    for c in out.checks:
        assert c.ok, (c.name, c.value, c.limit)
    assert out.values['dibr_mpix_s'] > 0 and out.values['setup_s'] > 0


def test_spc_reference_matches_plain_path():
    config, w = small_spc()
    out = drive(config, w)
    assert out.attempted >= w['sample']['within'] and out.failed == 0
    for c in out.checks:
        assert c.ok, (c.name, c.value, c.limit)
    assert out.values['spc_frame_p95_ms'] > 0


def test_octree_of_reference_voxels():
    """The reference's octree bytes and leaf offset against the program's
    packing of the same points."""
    from kaolin_tpu_torch.ops.spc import points as P
    vox = torch.unique(torch.randint(0, 64, (2000, 3)), dim=0)
    vox = vox[torch.argsort(ref_spc.morton(vox))]
    got = ref_spc.octree_bytes(vox, 6)
    want = P.unbatched_points_to_octree(vox, 6, device='cpu')
    assert torch.equal(got, want)


def test_trace_orders_hits_by_depth():
    vox = torch.tensor([[0, 0, 3], [0, 0, 1], [0, 0, 2], [1, 1, 1]])
    o = torch.tensor([[-0.9, -0.9, -2.0]])
    d = torch.tensor([[0., 0., 1.]])
    cnt, t, ids = ref_spc.trace(vox, 2, o, d, knum=4)
    assert int(cnt) == 3
    assert ids[0, :3].tolist() == [1, 2, 0]
    assert torch.all(t[0, :3][1:] > t[0, :3][:-1]) and torch.isinf(t[0, 3])

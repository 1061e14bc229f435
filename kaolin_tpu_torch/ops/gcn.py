"""Graph convolution (Kipf & Welling style) on meshes.

Port of ``kaolin_tpu/ops/gcn.py``.  The sparse adjacency is a
``torch.sparse_coo_tensor`` (as :func:`~kaolin_tpu_torch.ops.mesh.
adjacency_matrix` returns); the layer is an ``nn.Module`` whose weights
load from the JAX module's flax params through :func:`from_jax_params`.
"""

import numpy as np
import torch
from torch import nn

from kaolin_tpu_torch._device import entry_device

__all__ = ['sparse_bmm', 'normalize_adj', 'GraphConv', 'from_jax_params']


def sparse_bmm(sparse_matrix, dense_matrix_batch):
    """Multiply an unbatched sparse ``(M, N)`` matrix with a batched dense
    ``(B, N, P)`` matrix: ``(B, M, P)``."""
    b, n, p = dense_matrix_batch.shape
    dense = dense_matrix_batch.transpose(0, 1).reshape(n, b * p)
    result = torch.sparse.mm(sparse_matrix, dense)
    return result.reshape(-1, b, p).transpose(0, 1)


def _row_sums(adj):
    ones = torch.ones((adj.shape[1], 1), dtype=torch.float32,
                      device=adj.device)
    return (torch.sparse.mm(adj, ones) if adj.is_sparse else adj @ ones)


def normalize_adj(adj):
    """Row-normalize an adjacency matrix (sparse or dense)."""
    norm = _row_sums(adj)
    if adj.is_sparse:
        adj = adj.coalesce()
        indices = adj.indices()
        return torch.sparse_coo_tensor(
            indices, adj.values() / norm[indices[0], 0], adj.shape,
            check_invariants=False)
    return adj / norm


class GraphConv(nn.Module):
    """Graph convolution layer ``D^-1 A H W (+ H W_self)``.

    Args:
        input_dim, output_dim: feature dims.
        self_layer: add a separate self-feature linear layer.
        bias: add a bias to the linear layers.
        device: where the weights go (default: the card).
    """

    def __init__(self, input_dim, output_dim, self_layer=True, bias=True,
                 device=None):
        super().__init__()
        device = entry_device(device)
        self.linear = nn.Linear(input_dim, output_dim, bias=bias,
                                device=device)
        self.linear_self = (nn.Linear(input_dim, output_dim, bias=bias,
                                      device=device) if self_layer
                            else None)
        for layer in (self.linear, self.linear_self):
            if layer is not None:
                nn.init.xavier_uniform_(layer.weight)
                if bias:
                    nn.init.zeros_(layer.bias)

    def forward(self, node_feat, adj, normalize_adj=True):
        h = self.linear(node_feat)
        if adj.is_sparse:
            result = sparse_bmm(adj, h)
        else:
            result = torch.matmul(adj, h)
        if normalize_adj:
            result = result / _row_sums(adj)
        if self.linear_self is not None:
            result = result + self.linear_self(node_feat)
        return result


def from_jax_params(params, device=None):
    """The state dict of a :class:`GraphConv` from the JAX module's flax
    params (``{'linear': {'kernel': (in, out), 'bias': (out,)},
    'linear_self': ...}``; a dict with a ``'params'`` key is unwrapped), on
    ``device`` (default: the card); load it with ``load_state_dict``."""
    device = entry_device(device)
    params = params.get('params', params)
    out = {}
    for name, dense in params.items():
        out[f'{name}.weight'] = torch.as_tensor(
            np.array(dense['kernel'], dtype=np.float32).T.copy(),
            device=device)
        if 'bias' in dense:
            out[f'{name}.bias'] = torch.as_tensor(
                np.array(dense['bias'], dtype=np.float32), device=device)
    return out

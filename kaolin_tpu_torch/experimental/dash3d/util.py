"""dash3d server utilities: geometry indexing + binary streaming.

Port of ``kaolin_tpu/experimental/dash3d/util.py``: the same bytes for the
same arrays.  The encoders take tensors on any device (or arrays); the
decoder gives numpy arrays, as the wire format is the host's.  Serializes
Timelapse geometry into a compact binary wire format consumed by the JS
client:

    header:  magic 'KAO1' | u32 msg_type | u32 num_arrays
    arrays:  u32 dtype(0=f32, 1=u32) | u32 ndim | u32 shape[ndim] | payload

msg_type: 1 = mesh (vertices, faces), 2 = pointcloud (points).
"""

import struct

import numpy as np
import torch

from kaolin_tpu_torch.io import usd as usd_io
from kaolin_tpu_torch.visualize.timelapse import TimelapseParser

__all__ = ['StreamingGeometryHelper', 'serialize_arrays',
           'deserialize_arrays', 'meshes_to_binary',
           'point_clouds_to_binary']

MAGIC = b'KAO1'
MSG_MESH = 1
MSG_POINTCLOUD = 2
_DTYPES = {0: np.float32, 1: np.uint32}


def _host(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def serialize_arrays(msg_type, arrays):
    """Pack arrays into the binary wire format."""
    parts = [MAGIC, struct.pack('<II', msg_type, len(arrays))]
    for arr in arrays:
        arr = _host(arr)
        if arr.dtype.kind in 'iu':
            arr = arr.astype(np.uint32)
            code = 1
        else:
            arr = arr.astype(np.float32)
            code = 0
        parts.append(struct.pack('<II', code, arr.ndim))
        parts.append(struct.pack(f'<{arr.ndim}I', *arr.shape))
        parts.append(arr.tobytes())
    return b''.join(parts)


def deserialize_arrays(payload):
    """Unpack the binary wire format -> (msg_type, list of arrays)."""
    assert payload[:4] == MAGIC, 'bad magic'
    msg_type, num = struct.unpack('<II', payload[4:12])
    off = 12
    arrays = []
    for _ in range(num):
        code, ndim = struct.unpack('<II', payload[off:off + 8])
        off += 8
        shape = struct.unpack(f'<{ndim}I', payload[off:off + 4 * ndim])
        off += 4 * ndim
        dtype = _DTYPES[code]
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(payload[off:off + 4 * count],
                            dtype=dtype).reshape(shape)
        off += 4 * count
        arrays.append(arr)
    return msg_type, arrays


def meshes_to_binary(vertices_list, faces_list):
    """Encode meshes in the reference dash3d wire format: header
    ``[nmeshes, texture_mode, 0, 0]`` (int32) then per mesh
    ``[nvertices, nfaces]`` + f32 vertices + i32 faces.
    """
    nmeshes = len(vertices_list)
    if len(faces_list) != nmeshes:
        raise RuntimeError(
            f'Expected equal number of vertex and face lists, got: '
            f'{nmeshes}, {len(faces_list)}')
    parts = [np.array([nmeshes, 0, 0, 0], dtype=np.int32).tobytes()]
    for vertices, faces in zip(vertices_list, faces_list):
        vertices = _host(vertices)
        faces = _host(faces)
        parts.append(np.array([vertices.size // 3, faces.size // 3],
                              dtype=np.int32).tobytes())
        parts.append(vertices.astype(np.float32).tobytes())
        parts.append(faces.astype(np.int32).tobytes())
    return b''.join(parts)


def point_clouds_to_binary(positions_list):
    """Encode pointclouds in the reference dash3d wire format: header
    ``[nclouds, texture_mode, 0, 0]`` then per cloud ``[npts, 0]`` +
    f32 bbox mins + maxes + f32 positions.
    """
    nclouds = len(positions_list)
    parts = [np.array([nclouds, 0, 0, 0], dtype=np.int32).tobytes()]
    for positions in positions_list:
        positions = _host(positions).reshape(-1, 3)
        parts.append(np.array([positions.shape[0], 0],
                              dtype=np.int32).tobytes())
        parts.append(positions.min(axis=0).astype(np.float32).tobytes())
        parts.append(positions.max(axis=0).astype(np.float32).tobytes())
        parts.append(positions.astype(np.float32).tobytes())
    return b''.join(parts)


class StreamingGeometryHelper:
    """Index a Timelapse logdir and produce binary geometry messages
    (the geometry is read onto the host: the messages are bytes)."""

    def __init__(self, logdir):
        self.logdir = logdir
        self.parser = TimelapseParser(logdir)

    def refresh(self):
        self.parser.parse()

    def summary(self):
        """JSON-able summary of available geometry."""
        out = {}
        for typ in ('mesh', 'pointcloud'):
            items = []
            for b in self.parser.dir_info[typ]:
                items.append({
                    'category': b['category'],
                    'id': b['id'],
                    'timestamps': self.parser.get_timestamps(
                        typ, b['category'], b['id']),
                })
            out[typ] = items
        return out

    def get_mesh_message(self, category, id, time=None):
        path = self.parser.get_file_path('mesh', category, id)
        if path is None:
            return None
        mesh = usd_io.import_mesh(path, time=time, device='cpu')
        vertices = mesh.vertices.numpy().astype(np.float32)
        faces = mesh.faces.numpy().astype(np.uint32)
        return serialize_arrays(MSG_MESH, [vertices, faces])

    def get_pointcloud_message(self, category, id, time=None):
        path = self.parser.get_file_path('pointcloud', category, id)
        if path is None:
            return None
        points, _colors, _normals = usd_io.import_pointcloud(
            path, f'/pointcloud_{id}', time=time, device='cpu')
        return serialize_arrays(MSG_POINTCLOUD,
                                [points.numpy().astype(np.float32)])

"""The port's dash3d against kaolin_tpu's, on the CPU.

One Timelapse logdir written by the port: both packages'
``StreamingGeometryHelper`` give the same summary and the same message
bytes; the encoders give the same bytes for the same arrays (tensors on
the port's side); the port's tornado server answers HTTP and websocket
requests as ``tests/test_dash3d.py`` drives the JAX one;
``get_max_viewports``.
"""
import asyncio
import json
import socket

import numpy as np
import pytest
import torch

from kaolin_tpu.experimental.dash3d import run as run_j
from kaolin_tpu.experimental.dash3d import util as util_j
from kaolin_tpu_torch.experimental.dash3d import run as run_t
from kaolin_tpu_torch.experimental.dash3d import util as util_t
from kaolin_tpu_torch.visualize import Timelapse


@pytest.fixture(scope='module')
def logdir(tmp_path_factory):
    path = tmp_path_factory.mktemp('timelapse')
    tl = Timelapse(str(path))
    rng = np.random.default_rng(0)
    verts = torch.as_tensor(rng.normal(size=(20, 3)).astype(np.float32))
    faces = torch.tensor([[0, 1, 2], [3, 4, 5], [2, 7, 9]])
    for it in (0, 5):
        tl.add_mesh_batch(iteration=it, category='output',
                          vertices_list=[verts * (it + 1)],
                          faces_list=[faces])
        tl.add_pointcloud_batch(iteration=it, category='input',
                                pointcloud_list=[verts - it])
    return str(path)


def test_same_messages(logdir):
    h_j = util_j.StreamingGeometryHelper(logdir)
    h_t = util_t.StreamingGeometryHelper(logdir)
    assert h_t.summary() == h_j.summary()
    assert h_t.summary()['mesh'][0]['timestamps'] == [0.0, 5.0]
    for t in (None, 0, 5):
        msg = h_t.get_mesh_message('output', 0, time=t)
        assert msg == h_j.get_mesh_message('output', 0, time=t)
        msg = h_t.get_pointcloud_message('input', 0, time=t)
        assert msg == h_j.get_pointcloud_message('input', 0, time=t)
    typ, (v, f) = util_t.deserialize_arrays(
        h_t.get_mesh_message('output', 0, time=5))
    assert typ == util_t.MSG_MESH and v.shape == (20, 3) and f.shape == (3, 3)
    assert h_t.get_mesh_message('nope', 0) is None
    assert h_t.get_pointcloud_message('nope', 0) is None


def test_same_encodings():
    rng = np.random.default_rng(1)
    verts = [rng.normal(size=(7, 3)).astype(np.float32),
             rng.normal(size=(4, 3)).astype(np.float32)]
    faces = [np.array([[0, 1, 2], [2, 3, 6]]), np.array([[0, 1, 3]])]
    tv, tf = [torch.as_tensor(v) for v in verts], [torch.as_tensor(f)
                                                   for f in faces]
    assert (util_t.meshes_to_binary(tv, tf)
            == util_j.meshes_to_binary(verts, faces))
    assert (util_t.point_clouds_to_binary(tv)
            == util_j.point_clouds_to_binary(verts))
    arrays = [verts[0], faces[0].astype(np.uint32), np.float32(3.)]
    payload = util_t.serialize_arrays(util_t.MSG_MESH,
                                      [torch.as_tensor(a) for a in arrays])
    assert payload == util_j.serialize_arrays(util_j.MSG_MESH, arrays)
    typ, back = util_t.deserialize_arrays(payload)
    assert typ == util_t.MSG_MESH
    for a, b in zip(arrays, back):
        assert a.tobytes() == b.tobytes() and a.shape == b.shape
    with pytest.raises(RuntimeError, match='equal number'):
        util_t.meshes_to_binary(tv, tf[:1])


def test_get_max_viewports():
    for args in ({}, {'maxviews': '5'}, {'maxviews': '0'},
                 {'maxviews': '99'}, {'maxviews': 'x'}):
        assert run_t.get_max_viewports(args) == run_j.get_max_viewports(args)


def test_static_files_are_copies():
    import os
    for name in ('index.html', 'client.js'):
        with open(os.path.join(run_t.STATIC_DIR, name), 'rb') as a, \
                open(os.path.join(run_j.STATIC_DIR, name), 'rb') as b:
            assert a.read() == b.read()


def test_server_http_and_websocket(logdir):
    pytest.importorskip('tornado')
    import tornado.httpclient
    import tornado.websocket

    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    results = {}

    async def run_test():
        run_t.create_server(logdir, port)
        client = tornado.httpclient.AsyncHTTPClient()
        resp = await client.fetch(f'http://localhost:{port}/summary')
        results['summary'] = json.loads(resp.body)
        resp = await client.fetch(f'http://localhost:{port}/')
        results['index'] = resp.body.decode()
        resp = await client.fetch(f'http://localhost:{port}/static/client.js')
        results['js'] = len(resp.body)
        ws = await tornado.websocket.websocket_connect(
            f'ws://localhost:{port}/websocket')
        await ws.write_message(json.dumps(
            {'type': 'mesh', 'category': 'output', 'id': 0, 'time': 5}))
        results['mesh'] = await ws.read_message()
        await ws.write_message(json.dumps(
            {'type': 'pointcloud', 'category': 'input', 'id': 0}))
        results['points'] = await ws.read_message()
        await ws.write_message(json.dumps(
            {'type': 'mesh', 'category': 'nope', 'id': 0}))
        results['error'] = json.loads(await ws.read_message())
        ws.close()

    asyncio.run(run_test())
    helper = util_j.StreamingGeometryHelper(logdir)
    assert results['summary'] == helper.summary()
    assert 'kaolin-dash3d' in results['index'] and results['js'] > 0
    assert results['mesh'] == helper.get_mesh_message('output', 0, time=5)
    assert results['points'] == helper.get_pointcloud_message('input', 0)
    assert 'not found' in results['error']['error']

"""Dry run of the multi-GPU DIB-R step: N ranks, one sharded Adam step each.

The port's counterpart of ``__graft_entry__.py::dryrun_multichip`` and
``dryrun_multihost``: views sharded over the ranks, the parameters
replicated, the loss and gradients summed over the ranks by
:func:`~kaolin_tpu_torch.parallel.sharding.multi_view_grad`.

:func:`run` spawns the ranks (``torch.multiprocessing``, start method
``spawn``: CUDA cannot start in a forked child), has each join a process
group through a ``file://`` store in a fresh temporary directory (no port to
pick, so runs side by side do not collide) and run a list of jobs, and
returns every rank's results.  It has a hard overall time cap: when the cap
is reached, every rank is killed and the call raises; so does a rank that
fails, with its output.  The jobs are functions of this module, so that the
spawned ranks can import them: :func:`sharded_step` (the DIB-R step) and
:func:`tile_checks` (the row-sharded ``'jnp'`` loss and selection).

Every job takes its scene as numpy arrays (:func:`make_scene`), made once
by the caller, so that a one-process reference (:func:`one_process_step`)
can run on the same inputs.

Usage: ``python -m kaolin_tpu_torch.parallel.dryrun [--ranks 2]
[--height 128] [--device cpu] [--dist-backend gloo] [--timeout 600]``; on
the card by
default.  Build the CUDA kernels in the caller before spawning, or each rank
builds them itself.
"""

import argparse
import math
import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.models import inverse_render as M
from kaolin_tpu_torch.parallel import distributed as D
from kaolin_tpu_torch.parallel.sharding import (make_mesh, multi_view_grad,
                                                replicate, shard_views)
from kaolin_tpu_torch.parallel.tile import (tile_sharded_render_loss,
                                            tile_sharded_selection)
from kaolin_tpu_torch.render.mesh import _fused
from kaolin_tpu_torch.utils.testing import uv_sphere

__all__ = ['run', 'dryrun', 'make_scene', 'start_model', 'view_loss',
           'one_process_step', 'sharded_step', 'tile_checks']

TIMEOUT_S = 600.
VIEWS_PER_RANK = 2
PARAMS = ('vertices', 'texture_map', 'sh_coeffs')
VIEW_FIELDS = ('camera_rot', 'camera_trans', 'target_images',
               'target_masks')


def make_scene(height, num_views, texture_res=64, sphere=(32, 17),
               backend='fused', knum=30, device=None):
    """The DIB-R trainer's inputs as numpy arrays, drawn from numpy seed
    0: a turntable of ``num_views`` cameras, targets rendered on ``device``
    (default: the card) from ``uv_sphere(*sphere)`` with a random texture,
    and the start point: the sphere perturbed by 0.05 N(0, 1), another
    random texture, SH DC 3.

    Returns:
        dict of numpy arrays: ``vertices``, ``texture_map``, ``sh_coeffs``,
        ``faces``, ``face_uvs``, ``camera_rot``, ``camera_trans``,
        ``camera_proj``, ``target_images``, ``target_masks``.
    """
    dev = entry_device(device)
    rng = np.random.default_rng(0)
    s = uv_sphere(*sphere)
    verts = (s.vertices * 0.5).astype(np.float32)
    sh = np.zeros(9, np.float32)
    sh[0] = 3.
    gt = M.from_jax_params(
        verts, rng.random((3, texture_res, texture_res), dtype=np.float32),
        sh, device=dev)
    faces = torch.as_tensor(s.faces, device=dev)
    face_uvs = torch.as_tensor(s.uvs[s.face_uvs_idx], dtype=torch.float32,
                               device=dev)
    views = M.make_views(num_views, device=dev)
    with torch.no_grad():
        images, masks, _ = M.render_views(gt, views, faces, face_uvs, height,
                                          height, backend=backend, knum=knum)
    out = dict(
        vertices=verts + 0.05 * rng.standard_normal(verts.shape,
                                                    dtype=np.float32),
        texture_map=rng.random((3, texture_res, texture_res),
                               dtype=np.float32),
        sh_coeffs=sh, faces=s.faces, face_uvs=s.uvs[s.face_uvs_idx],
        target_images=images, target_masks=masks,
        **dict(zip(('camera_rot', 'camera_trans', 'camera_proj'), views)))
    return {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in out.items()}


def start_model(scene, device=None):
    """The trainer's start point of ``scene`` as an ``InverseRender`` on
    ``device`` (default: the card)."""
    return M.from_jax_params(*(scene[k] for k in PARAMS), device=device)


def view_loss(scene, height, dev, backend='fused', knum=30):
    """``loss_fn(params, views)`` for :func:`multi_view_grad`: the
    trainer's ``render_loss`` (selection included) of a shard of the views,
    ``views = (camera_rot, camera_trans, target_images, target_masks)``,
    times the shard's share of all ``len(scene['camera_rot'])`` views.
    ``render_loss`` is a mean over the views, so these sum over the ranks
    to the one-process loss of every view."""
    faces = torch.as_tensor(scene['faces'], device=dev)
    face_uvs = torch.as_tensor(scene['face_uvs'], device=dev)
    proj = torch.as_tensor(scene['camera_proj'], device=dev)
    num_views = len(scene['camera_rot'])

    def loss_fn(params, views):
        rot, trans, t_img, t_mask = views
        v = M.CameraViews(rot, trans, proj)
        sel = M.compute_selection(params, v, faces, height, height,
                                  backend=backend, knum=knum)
        loss = M.render_loss(params, v, faces, face_uvs, t_img, t_mask,
                             height, height, backend=backend, selection=sel,
                             knum=knum)
        return loss * (rot.shape[0] / num_views)
    return loss_fn


def one_process_step(scene, height, backend='fused', knum=30, device=None):
    """The same step on one process over every view: (loss, [gradient per
    parameter]) as a float and numpy arrays."""
    dev = entry_device(device)
    model = start_model(scene, dev)
    views = tuple(torch.as_tensor(scene[k], device=dev)
                  for k in VIEW_FIELDS)
    loss = view_loss(scene, height, dev, backend, knum)(model.as_params(),
                                                        views)
    grads = torch.autograd.grad(loss, list(model.as_params()))
    return loss.item(), [g.cpu().numpy() for g in grads]


def sharded_step(dev, scene, height, backend='fused', knum=30, lr=5e-3):
    """Job: one sharded Adam step of the DIB-R trainer over every rank
    (mesh ``('data',)``): each rank takes its shard of the views
    (:func:`shard_views`), the parameters replicated from rank 0, the loss
    and gradients from :func:`multi_view_grad`.

    Returns:
        dict: ``loss``, ``gnorm`` (the gradients' global 2-norm), ``grads``
        (numpy, per parameter, before the update), ``launches`` (K1 and K2
        in the step), ``moved`` (each parameter changed by Adam) and
        ``view_bytes`` (the bytes of storage this rank's views hold).
    """
    mesh = D.make_global_mesh(device=dev)
    views = shard_views(mesh, tuple(scene[k] for k in VIEW_FIELDS))
    model = M.InverseRender(*replicate(mesh, start_model(scene, dev)
                                       .as_params()))
    step = multi_view_grad(view_loss(scene, height, dev, backend, knum),
                           mesh)
    before = dict(_fused.LAUNCHES)
    loss, grads = step(model.as_params(), views)
    launches = {k: _fused.LAUNCHES[k] - before[k] for k in before}
    start = [p.detach().clone() for p in model.parameters()]
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for p, g in zip(model.parameters(), grads):
        p.grad = g
    opt.step()
    return dict(
        loss=loss.item(),
        gnorm=math.sqrt(sum(float(g.double().square().sum())
                            for g in grads)),
        grads=[g.cpu().numpy() for g in grads], launches=launches,
        moved=[not torch.equal(a, p.detach())
               for a, p in zip(start, model.parameters())],
        view_bytes=sum(v.untyped_storage().nbytes() for v in views))


def tile_checks(dev, scene, height, knum=30,
                meshes=((1, 2), (2, 1)), selection_mesh=(1, 2)):
    """Job: :func:`tile_sharded_render_loss` on each ``(data, tile)`` mesh
    shape of ``meshes`` (its value and gradients to the parameters), and
    :func:`tile_sharded_selection` on ``selection_mesh``, at the scene's
    start point.

    Returns:
        dict: ``loss`` {shape: (value, [gradient per parameter])},
        ``selection`` (B, H, W) int32, ``shapes`` {shape: mesh.shape}.
    """
    views = M.CameraViews(*(torch.as_tensor(scene[k], device=dev) for k in (
        'camera_rot', 'camera_trans', 'camera_proj')))
    faces = torch.as_tensor(scene['faces'], device=dev)
    face_uvs = torch.as_tensor(scene['face_uvs'], device=dev)
    t_img = torch.as_tensor(scene['target_images'], device=dev)
    t_mask = torch.as_tensor(scene['target_masks'], device=dev)
    out = dict(loss={}, shapes={})
    for shape in meshes:
        mesh = make_mesh(shape, ('data', 'tile'), device=dev)
        params = start_model(scene, dev).as_params()
        loss = tile_sharded_render_loss(mesh, params, views, faces, face_uvs,
                                        t_img, t_mask, height, height,
                                        knum=knum)
        grads = torch.autograd.grad(loss, list(params))
        out['loss'][shape] = (loss.item(), [g.cpu().numpy() for g in grads])
        out['shapes'][shape] = dict(mesh.shape)
    mesh = make_mesh(selection_mesh, ('data', 'tile'), device=dev)
    with torch.no_grad():
        fvc, fvi, fn = M._prepare(start_model(scene, dev), views, faces)
    out['selection'] = tile_sharded_selection(
        mesh, fvc[..., 2], fvi, fn[..., 2] >= 0., height,
        height).cpu().numpy()
    return out


def _rank(rank, world_size, init_method, dist_backend, device, jobs,
          log_path, results):
    """A spawned rank: its output to ``log_path``, then the jobs; puts
    (rank, 'ok', [result per job]) or (rank, 'error', traceback)."""
    with open(log_path, 'w') as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    if device == 'cpu':     # a share of the cores: more threads spin idle
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        dev = D.initialize(init_method, world_size, rank,
                           backend=dist_backend, device=device)
        out = [job(dev, **kwargs) for job, kwargs in jobs]
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        results.put((rank, 'ok', out))
    except Exception:
        results.put((rank, 'error', traceback.format_exc()))
        raise
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        if dist.is_initialized():
            dist.destroy_process_group()


def _log(path):
    try:
        with open(path) as f:
            return f.read()[-20000:]
    except OSError:
        return ''


def run(world_size, jobs, timeout=TIMEOUT_S, dist_backend=None,
        device=None):
    """Spawn ``world_size`` ranks that each run ``jobs``, a sequence of
    ``(job, kwargs)``, as ``job(device, **kwargs)`` in order.

    Args:
        world_size: the number of ranks.
        jobs: module-level functions (the ranks import them) and their
            keyword arguments (pickled to every rank).
        timeout: hard cap in seconds on the whole call, start-up included.
        dist_backend: ``'nccl'`` or ``'gloo'`` (default: nccl on the card,
            gloo on the CPU).  Ranks that share a card need gloo.
        device: ``'cpu'``, or None for the card: rank r takes
            ``cuda:{r % torch.cuda.device_count()}``.

    Returns:
        ``[rank][job]`` results.

    Raises:
        RuntimeError: a rank failed (with its output), or the cap was
            reached (every rank is killed first).
    """
    dev = entry_device(device)
    ctx = torch.multiprocessing.get_context('spawn')
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix='kaolin_dryrun_') as tmp:
        logs = [os.path.join(tmp, f'rank{r}.log') for r in range(world_size)]
        procs = [ctx.Process(
            target=_rank, daemon=True,
            args=(r, world_size, 'file://' + os.path.join(tmp, 'store'),
                  dist_backend, dev.type, list(jobs), logs[r], results))
            for r in range(world_size)]
        out = {}
        try:
            for p in procs:
                p.start()
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f'dry run: {world_size} ranks did not finish within '
                        f'the cap of {timeout:g} s; every rank killed. '
                        + ''.join(f'\n--- rank {r} output:\n{_log(logs[r])}'
                                  for r in range(world_size)))
                try:
                    rank, status, payload = results.get(
                        timeout=min(left, 1.))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in out and p.exitcode is not None:
                            raise RuntimeError(
                                f'dry run: rank {r} exited with code '
                                f'{p.exitcode} and no result:\n'
                                f'{_log(logs[r])}')
                    continue
                if status != 'ok':
                    raise RuntimeError(f'dry run: rank {rank} failed:\n'
                                       f'{payload}\n--- rank {rank} '
                                       f'output:\n{_log(logs[rank])}')
                out[rank] = payload
            for r, p in enumerate(procs):
                p.join(max(deadline - time.monotonic(), 0.))
                if p.exitcode != 0:
                    raise RuntimeError(
                        f'dry run: rank {r} exit code {p.exitcode} after its '
                        f'result (cap {timeout:g} s):\n{_log(logs[r])}')
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [out[r] for r in range(world_size)]


def dryrun(num_ranks=2, height=128, dist_backend=None, device=None,
           timeout=TIMEOUT_S):
    """One sharded Adam step of the fused DIB-R trainer on ``num_ranks``
    spawned ranks (:func:`sharded_step`), ``VIEWS_PER_RANK`` views each,
    the scene (:func:`make_scene`'s defaults) made here on ``device``.

    Returns:
        per rank, the dict of :func:`sharded_step`.

    Raises:
        RuntimeError: as :func:`run`, or the ranks disagree on the loss or
            the gradient norm.
    """
    dev = entry_device(device)
    scene = make_scene(height, num_ranks * VIEWS_PER_RANK, device=dev)
    out = [r[0] for r in run(num_ranks, [(sharded_step, dict(
        scene=scene, height=height))], timeout, dist_backend, dev)]
    for key in ('loss', 'gnorm'):
        if len({r[key] for r in out}) != 1:
            raise RuntimeError(f'dry run: the ranks disagree on the {key}: '
                               f'{[r[key] for r in out]}')
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--ranks', type=int, default=2)
    parser.add_argument('--height', type=int, default=128)
    parser.add_argument('--dist-backend', default=None)
    parser.add_argument('--device', default=None)
    parser.add_argument('--timeout', type=float, default=TIMEOUT_S)
    args = parser.parse_args(argv)
    out = dryrun(args.ranks, args.height, args.dist_backend, args.device,
                 args.timeout)
    for r, res in enumerate(out):
        print(f'rank {r}: loss {res["loss"]:.7f}, gradient norm '
              f'{res["gnorm"]:.7f}, launches {res["launches"]}')
    return out


if __name__ == '__main__':
    main()

#!/usr/bin/env python3
"""Smoke run of kaolin_tpu_torch, the PyTorch + CUDA port, on one GPU.

Drives the port's paths and checks them phase by phase.

The DIB-R inverse-rendering trainer of
``examples/dibr_inverse_rendering.py`` (fused selection -> textured,
SH-lit render -> image L1 + mask IoU loss -> backward -> Adam) at 512^2,
4 views, a 256^2 texture and a 10,000-face textured UV sphere:

1. toolchain: the card, torch, nvcc, triton; every kernel source in
   ``kaolin_tpu_torch/csrc`` is built at once, one ``nvcc`` each, into
   ``build/kaolin_tpu_torch/``, and the host library (``g++``, the
   ``csrc/*.cpp`` copies) beside them;
2. the forward kernel (K1) against its plain PyTorch version;
3. the backward kernel (K2) against its plain PyTorch version; the work
   both kernels cull to (K1's evaluated (pixel, face) pairs beside those of
   one CTA per tile walking whole chunks, its face lists per sub-tile, K2's
   sub-tiles with a non-zero g*prod), counted in torch from their rules;
   the epilogue's kernels E1-E3 (``csrc/epilogue.cu``: the bilinear
   texture sample, its backward, the face-row scatter of ``gather_rows``'
   backward) on one eager step's own inputs (E1's those of
   ``render_views``: the step's albedo is the shading kernel's) against
   their plain versions, each run again for the same bits, two steps'
   gradients compared bit for bit, their times by both timers in turns with
   ``grid_sample``, ``grid_sampler_2d_backward`` and ``index_add_``, and
   their bounds; the shading (``render/mesh/_shade.py``: the per-pixel
   chain from the face rows to the L1 + IoU loss terms and its backward,
   ``csrc/shade.cuh``) against its plain version on the cell's start point
   (loss terms, the gradients to the corners, normals, texture, SH and soft
   mask), run again for the same bits, its kernels' device times beside
   their bounds and the plain version's;
4. 5 Adam steps of the compiled step (``models.inverse_render.
   compiled_step``: one CUDA graph replayed a step, K1, K2, E2, E3 and the
   shading in it) against 5 eager steps from the same parameters (the
   first replay's face ids, soft-mask product, loss and gradients bit for
   bit, every loss within step 0's limit; the 'jnp' backend's gradients
   within 1e-5 of their largest), K1, K2, E2 and E3 as captured held
   against their plain versions on the graph's inputs, one launch of each
   and of the shading's two counted per replay, none of E1; then step 0's
   loss and gradients at
   128^2 and one view on the card against the same step on the CPU, where
   the wrappers run the plain versions (phases 2-3 hold the kernels
   against their plain versions at full size);
5. times (CUDA events after warm-up) of the eager step and the compiled
   step in turns, of the compiled step's graph alone, and of each kernel
   beside its plain version; both steps on the card's timeline
   (``torch.profiler``): kernels per step, device busy and idle share, the
   largest kernels (none of ``grid_sample``'s left); their peak memory.

The SPC pipeline of BASELINE config #3 (mesh -> level-10 octree -> coherent
trace of 1,048,576 camera rays -> per-ray opacity), on the same 10,000-face
sphere scaled to radius 0.45 (~1.0M voxels at level 10):

6. build: the device mesh builder against the host builder at level 8;
   level-10 builds at two capacities must be identical;
   then the main path, once, through the user entry points
   (``unbatched_mesh_to_spc_device`` -> ``scan_octrees`` ->
   ``generate_points`` -> ``build_cell_table`` ->
   ``unbatched_raytrace_coherent`` -> ``hits_to_nuggets`` ->
   ``exponential_integration``), with the launch counts of K3 and of the
   culling kernel C1 (``spc_cull_kernel``) read around it, C1's launch
   held bit for bit against its plain version on the inputs it was given;
   every live pidx must lie in the leaf level (K3 adds the level's offset);
7. K3 against its plain version on every active block of the scene, with
   pidx offset 0 and with the level's; the main path's hits against the
   trace whose offset is a ``torch.where`` pass after K3, bit for bit;
8. K3 against its plain version on a dense random level-6 octree whose
   rays hit more than 64 voxels and, some, more than the k-buffer, then on
   the same octree with voxels taken out of and put into its cell rows
   (rows with holes, empty rows, full rows with tied depths) and blocks
   with no candidate cell; both offsets, with and without exit depths;
9. the whole trace against the port's BFS on the 1,048,576 rays;
10. times of the trace, of the trace with the offset pass after K3, of K3,
    of C1 and its plain version on the main path's inputs, the cell table,
    the mesh-to-octree build and the BFS.

The probes of K3 and of the card (``kaolin_tpu_torch.probes``, the port of
the TPU probe scripts), each driven through its entry point ``run`` with
its kernels' launch counts set to 0 just before and read just after:

11. P1, ``probes.mosaic3``: kernels kA..kH against their plain versions on
    the script's inputs and a random x, bit for bit, kB/kC/kD at K3's
    staging shape (4,452 blocks x 61 rows of 4 x 192 from a table of the
    level-10 cell table's row count) and kA, kE..kH at the large shape
    (65,536 x 8 x 128); captured launches against eager ones; their times
    by both timers beside the library call's, in turns: kB (rows staged in
    shared memory by TMA bulk copies, its ring's slot count) against kC
    (rows straight into registers), and kE..kH against 50 % of their
    bound;
12. P2, ``probes.stages``: the dummy kernel (TMA in and out) against 2 x
    and its captured launch against the eager one, at 65,536 and 262,144
    steps in turns with ``torch.mul`` by both timers, its share of the
    bound; the trace of the SPC cell by stage (culling candidates, block
    order, gathers, the whole trace, K3, output fills, the trace with the
    offset pass after K3);
13. P3, ``probes.kbisect``: K3 cut at stages 1-6 (K3's template
    ``csrc/spc_trace.cuh`` instantiated in the probes' module, whose
    ``spc_trace`` library holds stage 6 only) against the plain version
    on the script's inputs, on a scene with rays past kbuf, and on phase
    8's dense level-6 octree; at the SPC cell every stage against plain
    and stage 6 equal to K3 bit for bit; each stage's time and its delta.

BASELINE config #1 (one OBJ, DIB-R at 256^2, backprop to the vertices)
and config #4 (DefTet sparse render + tetmesh losses), plain PyTorch (the
JAX package computes both without a Pallas kernel):

14. the sphere written as OBJ + MTL text, read by ``import_mesh`` onto the
    card (vertices, faces and face uvs equal to the generator's); the
    brute-force ``'jnp'`` selection against K1's (equal but at z ties);
    5 Adam steps of the trainer with ``backend='jnp'`` at 256^2, 4 views, a
    256^2 texture, knum 30 (the loss falls, no K1/K2 launch); step 0 at
    128^2, one view, against the CPU; times of the step, the z-buffer and
    k-buffer selections, the soft-mask epilogue forward and backward, and
    the step on the card's timeline;
15. ``bench.py::_phase_deftet``'s cell: 256^2, knum 30, one view, normals
    as features, the binned engine (max_candidates 2048, pixel_chunk
    1024) against the default engine on the card and against the CPU at
    64^2 (face_idx, features, gradients); fwd + bwd times of both;
16. a 32^3 tet grid of a cube (6 tets per cell) with a sphere's SDF:
    ``marching_tetrahedra``, one ``subdivide_tetmesh``, ``equivolume`` and
    ``amips`` with gradients, each on the card against the CPU; times.

The SPC features, sparse convolutions and Camera API (plain PyTorch but
K3; the JAX package computes them without a Pallas kernel), on the same
sphere's level-10 octree:

17. path A, NGLOD-style: ``unbatched_make_dual`` / ``unbatched_make_trinkets``,
    16 seeded features on the level-10 dual corners, a pinhole
    ``Camera.from_args`` at 1024^2 -> ``generate_rays`` ->
    ``unbatched_raytrace_coherent(engine='mosaic', grid_shape=...)`` (K3)
    -> ``hits_to_nuggets`` -> ``unbatched_interpolate_trilinear`` at each
    nugget's mid depth -> ``exponential_integration`` (channels 0-2 colour,
    3 optical thickness) -> L1 against a target from other features ->
    backward -> 5 Adam steps, K3's and C1's launches counted around them,
    each C1 launch held bit for bit against its plain version; K3 against
    its plain version on the camera's own rays (bit for bit), the trace
    against the BFS, step 0 at 128^2 against the CPU; times (step, trace,
    interpolation, integration, backward, K3 alone on pinhole rays), peak
    memory, the step on the card's timeline;
18. path B: ``Conv3d`` (16 -> 32, 3^3) -> ``Conv3d`` (32 -> 64, 2^3, jump 1)
    -> ``ConvTranspose3d`` (64 -> 32, 2^3, jump 1) over the level-10 ``Spc``,
    an L2 loss, backward; the stack at level 7 on the card against the CPU;
    ``to_dense`` at level 7, ``Spc.from_features`` of that grid and
    ``trianglemeshes_to_voxelgrids`` at 128^3 on the card against the CPU;
    forward and backward times, split per layer into ``unbatched_query``,
    the pair compaction, the gather and the per-tap matmul, peak memory,
    the step on the card's timeline.

Lighting, mesh and point-cloud metrics, sampling, ``check_sign``, the
voxel-grid ops and marching cubes (plain PyTorch but K1; the JAX package
computes them without a Pallas kernel):

19. path C, SG light recovery (DIB-R++, ``examples/sg_lighting_demo.py``
    at full size): the DIB-R cell's sphere with a 256^2 texture whose first
    64 rows are black, 4 pinhole cameras (``Camera.from_args``, 70 degree
    fov) at 512^2; ``rasterize(..., backend='fused')`` once per view (K1,
    its launches counted) -> nearest ``texture_mapping`` ->
    ``sg_diffuse_inner_product`` + ``sg_warp_specular_term`` (roughness
    0.3) over 32 lobes -> MSE on the covered pixels against a target from
    ground-truth lobes -> backward to amplitude, direction angles and
    sharpness -> 5 Adam steps (the loss falls); K1 against its plain
    version on path C's own per-view inputs at 512^2 (no soft mask), with
    its time there; step 0 at 128^2, one view, against the CPU; times and
    stage split, kernels per step, idle share, peak memory;
20. path D, DMTet chamfer fit (``examples/dmtet_demo.py`` at full size):
    ``tet_grid(64)`` of [-0.5, 0.5]^3 (1,572,864 tets) with a sphere SDF of
    radius 0.25 -> ``marching_tetrahedra`` -> ``sample_points`` (50,000) ->
    ``chamfer_distance`` to 100,000 points of an ellipsoid +
    0.1 x the mean squared ``uniform_laplacian_smoothing`` displacement ->
    backward to the SDF -> 5 Adam steps (the loss falls);
    ``average_edge_length`` and ``point_to_mesh_distance`` of 20,000 target
    points to the final surface; step 0 at ``tet_grid(16)`` against the CPU
    with the same face choices, u and v; the step's stages timed by CUDA
    events inside the same three steps, kernels per step, idle share, peak
    memory;
21. path E, occupancy evaluation: ``check_sign`` of the 128^3 cell centres
    against the sphere at radius 0.45 (every point farther than 1e-3 from
    the sphere decided as |p| < 0.45), ``downsample``, ``extract_surface``,
    ``fill`` (equal to the solid), ``extract_odms`` -> ``project_odms``,
    marching cubes and cubic meshes, ``iou`` against the filled
    ``trianglemeshes_to_voxelgrids``, ``chamfer_distance``, ``f_score`` and
    ``point_to_mesh_distance`` between 50,000 points sampled on the
    marching-cubes mesh and on the sphere; ``check_sign`` and marching
    cubes at 32^3 against the CPU; stage times, kernels, idle share, peak
    memory.

The port's native host layer, USD I/O, Timelapse and training-state
checkpoints around the DIB-R cell (plain PyTorch, host C++ and K1/K2):

22. path F, the ``--logdir`` workflow of
    ``examples/dibr_inverse_rendering.py`` and an ONet-style evaluation:
    the 10,000-face sphere written as OBJ and imported through the native
    tokenizer onto the card (and a 250,000-face sphere parsed by the native
    and the Python paths, timed, the arrays bit-equal); K1 and K2 against
    their plain versions on the first step's inputs, one view; 20 Adam
    steps of the DIB-R cell (fused, 4 views, 512^2) from the perturbed
    sphere, a ``Timelapse`` of the mesh and of 10,000 ``sample_points``
    at iterations 0, 5, 10 and 15, the state at step 10 saved with
    ``utils.checkpoint.save`` and ``save_npz``, loaded back bit-equal, and
    step 10 from the loaded state against step 10 in memory (loss and
    gradients within step 0's limits); step 0's E1-E3 launches against
    their plain versions; the loop on the card's timeline (idle share);
    ``TimelapseParser`` and the last sample read back bit for
    bit; ``sdf_to_voxelgrids`` (MISE 32 -> 257^3) of the fitted mesh with
    ``check_sign(use_hash=True)`` as occupancy, on the card and on the CPU
    (equal), the hash build, queries and device test timed level by level,
    the hash against the vectorised ``check_sign`` on 100,000 query points
    off a 1e-3 shell; marching cubes of the grid through ``export_mesh`` ->
    ``import_mesh`` and ``extract_surface`` through ``add_voxelgrid_batch``
    -> ``import_voxelgrid``, each bit-equal; times, peak memory.

The datasets, synthetic-view import, dash3d, the visualizers and the
examples (plain PyTorch and host code, K1/K2 on the fit and the frames, K3
in the SPC example):

23. path G: a ShapeNetCore V2 tree of 2 synsets x 3 models, each the
    10,000-face sphere deformed by a seeded low-frequency field, written as
    OBJ + MTL (and a ModelNet tree of 2 OFF models, a SHREC16 tree of 2
    OBJ models); ``ShapeNetV2(train=True, split=0.67)`` ->
    ``ProcessedDataset`` (mesh -> vertices, faces, face uvs) ->
    ``CachedDataset(save_on_disk=True)`` with 2 spawned workers, then again
    over the same cache (the base getter called once, the probe);
    ``CombinationDataset`` of ModelNet and SHREC16; a ``DataLoader`` (2
    workers, pinned memory) onto the card; each training model's 4 views
    at 512^2 through K1, written as synthetic views (silhouette, linear
    depth, camera metadata) and read back with ``import_synthetic_view``
    onto the card, the cameras taken from the metadata; 10 Adam steps
    fitting a sphere to model 0's silhouettes (soft mask through K1 and
    K2, ``mask_iou``) and depths (L1), a ``Timelapse`` of the mesh and of
    10,000 samples every 5 steps; K1 and K2 against their plain versions
    on the first step's inputs, step 0's E3 launch against plain, step 0
    at 128^2 against the CPU; the
    Timelapse through ``StreamingGeometryHelper`` (every message decoded
    bit-equal to what was logged); ``IpyTurntableVisualizer`` and
    ``IpyFirstPersonVisualizer`` frames of the fitted mesh through K1 after
    8 rotate / zoom events and 4 moves, the first frame's K1 launch held
    against plain; the five examples' ``main([...])`` on the card at
    ``tests/test_examples.py``'s sizes, every K1, K2, K3 and E1-E3 launch
    they make held against its plain version on the inputs it was given
    (C1's too).

The multi-GPU DIB-R step of BASELINE config #5 (``kaolin_tpu_torch.parallel``
on ``torch.distributed``; K1/K2 on every rank):

24. path H: world size 1 on NCCL in this process (a ``file://`` store):
    ``multi_view_grad`` over the fused trainer loss at the DIB-R cell
    (512^2, 4 views, 10,000 faces, a 256^2 texture), step 0 against the
    one-process step on the same inputs and its K1 / K2 / E1-E3 launches
    against their plain versions, 5 Adam steps (the loss falls; the launches
    counted as ``path_launches['path_h']``), the step in turns with the
    one-process step, its forward, backward and all-reduce inside the same
    step, its idle share; config #5's per-view width (1024^2, 8 views):
    K1 / K2 against plain on one view of the first step's inputs, the
    step's time, views/s and peak memory; then world size 2 on gloo, both
    ranks on this card, spawned under a hard cap
    (``parallel/dryrun.py::run``): the sharded step at 2 views a rank,
    equal on both ranks and against the one-process 4-view step, and the
    row-sharded ``'jnp'`` loss on (1 x 2) and (2 x 1) (data x tile) meshes
    and the row-sharded selection at 128^2, 2 views, against the
    one-process ``'jnp'`` loss and selection.  Prints the ``parallel``
    line (each world size with its backend, the card).

DIB-R++ (``models/dibrpp.py``: shape, a 4-channel albedo and roughness map
and 32 SG lights; K1, K2 and E1-E3 under PyTorch's SG shading), as the
benchmark's cell ``sg.lights.512x4`` runs it:

25. the DIB-R cell's sphere, views and vertex noise at 512^2, 4 views, a
    256^2 material map and path C's lights (targets from the ground truth,
    the start's lights perturbed); 5 Adam steps of ``compiled_step(...,
    loss_fn=dibrpp.render_loss)`` against 5 eager steps from the same
    start (step 0's loss and gradients bit for bit, every loss within step
    0's limit); K1, K2 and E1-E3 as launched inside the graph (E1 / E2 over
    the material's 4 channels, E3 over the face rows' 30 columns) against
    their plain versions, one launch of each counted per replay and none of
    the SH shading's; the step's time and peak memory.

Each phase prints its seconds, and the script its total.

Every kernel of the ``kernels`` line carries its time, its plain
version's, its bound (the larger of bytes over 3.35 TB/s and float32
operations over 67 TFLOP/s, counted on this run's inputs) and, where one
PyTorch call computes the same function, that call's time.  E1-E3's and
the shading's launches are counted on every path that renders through
``rasterize``'s epilogue and ``texture_mapping`` or ``render_loss``: the
DIB-R step, config #1, paths F, G (the fit and the examples) and H, and
the DIB-R++ step.

Every phase synchronises and raises on failure; there is no CPU path.
Usage: ``python3 chip_smoke.py`` from the root of the repository.  The last
line of its output is ``{"ok": true, "device": {...}}``; the line before
it lists the kernels.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import math
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kaolin_tpu_torch import _cuda, _native
from kaolin_tpu_torch.io import usd
from kaolin_tpu_torch.io.obj import import_mesh
from kaolin_tpu_torch.metrics import tetmesh as met_tet
from kaolin_tpu_torch.models import dibrpp as DP
from kaolin_tpu_torch.models import inverse_render as M
from kaolin_tpu_torch.ops.conversions.tetmesh import marching_tetrahedra
from kaolin_tpu_torch.ops.mesh.tetmesh import (inverse_vertices_offset,
                                               subdivide_tetmesh)
from kaolin_tpu_torch.probes import _kernels as PK
from kaolin_tpu_torch.probes import kbisect, mosaic3, stages
from kaolin_tpu_torch.ops.conversions.trianglemesh import (
    _tri_aabb_sat, trianglemeshes_to_voxelgrids, unbatched_mesh_to_spc,
    unbatched_mesh_to_spc_device)
from kaolin_tpu_torch.ops.spc import (
    Conv3d, ConvTranspose3d, generate_points, scan_octrees, to_dense,
    unbatched_get_level_points, unbatched_interpolate_trilinear,
    unbatched_make_dual, unbatched_make_trinkets, unbatched_points_to_octree,
    unbatched_query)
from kaolin_tpu_torch.ops.spc.convolution import (tap_coords, tap_pairs,
                                                  tap_products)
from kaolin_tpu_torch.render.camera import Camera
from kaolin_tpu_torch.ops import _scatter as SC
from kaolin_tpu_torch.render.mesh import _fused as FU
from kaolin_tpu_torch.render.mesh import _sample as SA
from kaolin_tpu_torch.render.mesh import _shade as SH
from kaolin_tpu_torch.render.mesh import (deftet_sparse_render,
                                          dibr_soft_mask,
                                          dibr_soft_mask_select,
                                          rasterize_selection)
from kaolin_tpu_torch.render.spc import (
    _trace, exponential_integration, hits_to_nuggets, mark_pack_boundaries,
    unbatched_raytrace)
from kaolin_tpu_torch.render.spc import raster as RS
from kaolin_tpu_torch.render.spc.raster import (
    _beam_bounds, _beam_chunk_test, _block_order, _pad_rays,
    build_cell_table, grid_order, trace_inputs, unbatched_raytrace_coherent)
from kaolin_tpu_torch.rep import Spc
from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch.metrics.pointcloud import chamfer_distance, f_score
from kaolin_tpu_torch.metrics.trianglemesh import (
    average_edge_length, point_to_mesh_distance, uniform_laplacian_smoothing)
from kaolin_tpu_torch.metrics.voxelgrid import iou
from kaolin_tpu_torch.ops.conversions.voxelgrid import (
    voxelgrids_to_cubic_meshes, voxelgrids_to_trianglemeshes)
from kaolin_tpu_torch.ops.coords import spherical2cartesian
from kaolin_tpu_torch.ops.mesh import (check_sign, index_vertices_by_faces,
                                       sample_points)
from kaolin_tpu_torch.ops.mesh.check_sign import _hash_parity
from kaolin_tpu_torch.ops.mesh.trianglemesh import (
    _base_sample_points_selected_faces)
from kaolin_tpu_torch.ops.conversions import sdf_to_voxelgrids
from kaolin_tpu_torch.utils import checkpoint as ckpt
from kaolin_tpu_torch.visualize import Timelapse, TimelapseParser
from kaolin_tpu_torch.ops.voxelgrid import (downsample, extract_odms,
                                            extract_surface, fill,
                                            project_odms)
from kaolin_tpu_torch.render.lighting import (sg_diffuse_inner_product,
                                              sg_warp_specular_term)
from kaolin_tpu_torch.render.mesh import rasterize, texture_mapping
from kaolin_tpu_torch.utils import measure
from kaolin_tpu_torch.utils.measure import TRACE, bound_ms, time_ms
from kaolin_tpu_torch.utils.testing import (
    CountedDataset, camera_grid, mesh_arrays, punch_cell_rows, tet_grid,
    uv_sphere, write_modelnet, write_shapenet_v2, write_shrec16,
    write_sphere_obj, write_synthetic_view)
from kaolin_tpu_torch.experimental.dash3d.util import (
    StreamingGeometryHelper, deserialize_arrays)
from kaolin_tpu_torch.io.dataset import (CachedDataset, CombinationDataset,
                                         ProcessedDataset)
from kaolin_tpu_torch.io.modelnet import ModelNet
from kaolin_tpu_torch.io.render import import_synthetic_view
from kaolin_tpu_torch.io.shapenet import ShapeNetV2
from kaolin_tpu_torch.io.shrec import SHREC16
from kaolin_tpu_torch.metrics.render import mask_iou
from kaolin_tpu_torch.ops.mesh import face_normals
from kaolin_tpu_torch.render.mesh import dibr_rasterization, prepare_vertices
from kaolin_tpu_torch.visualize.ipython import (IpyFirstPersonVisualizer,
                                                IpyTurntableVisualizer)
from kaolin_tpu_torch.parallel import (distributed as D, multi_view_grad,
                                       replicate, shard_views)
from kaolin_tpu_torch.parallel import dryrun as DR

HEIGHT = WIDTH = 512
VIEWS = 4
TEXTURE_RES = 256
SPHERE = (100, 51)          # uv_sphere(100, 51): 10,000 faces
STEPS = 5
LR = 5e-3
MULT = 1000.                # fused engine defaults (compute_selection)
SIGMAINV = 7000.
BOXLEN = 0.02
EPS = 1e-8

# acceptance limits of the kernels against their plain versions (same
# inputs, same card); only summation order differs, see csrc/dibr_fused.cu
K1_FID_MISMATCH_MAX = 1e-4  # share of pixels whose face id differs
K1_PROD_MAX = 1e-5          # max |prod_kernel - prod_plain|
K2_REL_MAX = 1e-3           # max |grad diff| / max |grad|
# the kernel path on the card against the plain path on the CPU: also
# differ in prepare_vertices' arithmetic and in the order of the
# index/grid_sample backward's atomic sums
STEP0_LOSS_RTOL = 1e-4
STEP0_GRAD_REL = 1e-3
# the compiled step's first replay against the eager step from the same
# parameters, by backend: the same kernels.  'fused' has no atomic sum left
# in its backward (E2 and E3 add in a fixed order), so its gradients are
# bit-equal; the 'jnp' soft mask's backward adds its k-buffer's vertex
# gradients with index_add_, in an order that changes from run to run
REPLAY_GRAD_REL = dict(fused=0., jnp=1e-5)
# E1-E3 against their plain versions (same inputs, same card): E1 the same
# ops in the same order; E2's texel sums and E3's row sums in another order
E1_MAX = 1e-6               # max |sample - plain| (texels in [0, 1))
E_REL_MAX = 1e-5            # max |d| / max |plain| of E2's dT, dx, dy, E3
# the shading (render/mesh/_shade.py) against its plain version (same
# inputs, same card): the loss terms' sums over the pixels and every
# gradient's sum over the pixels are taken in another order
SHADE_LOSS_RTOL = 1e-5
SHADE_GRAD_REL = 1e-4
# a step's parts, timed by contiguous CUDA events inside it, against the
# step: only the float rounding of elapsed_time lies between them
PARTS_RTOL, PARTS_ATOL_MS = 0.01, 0.01

KNUM = 30                   # soft-mask k-buffer depth ('jnp' backend)
# step 0 against the plain path on the CPU runs at this reduced size (the
# kernels are held against their plain versions at full size on the card)
STEP0_SIZE = dict(height=128, views=1)

# BASELINE config #1 (OBJ -> DIB-R 256^2 -> vertex gradients, 'jnp')
CFG1 = dict(height=256, views=4, texture_res=256, backend='jnp', knum=KNUM)
JNP_FID_MISMATCH_MAX = 1e-4  # share of pixels where 'jnp' and K1 differ
Z_TIE_REL = 1e-5            # ... each a z tie: both cover, z equal to this
# BASELINE config #4 (DefTet, as bench.py::_phase_deftet runs it)
DEFTET = dict(height=256, knum=30, max_candidates=2048, pixel_chunk=1024,
              check_height=64)
DEFTET_FEAT_ATOL = 1e-5
DEFTET_GRAD_REL = 1e-4
DEFTET_ZERO_GRAD = 1e-6     # a gradient that is 0 but for rounding (z)
# tetmesh ops and losses
TET_GRID = 32               # 32^3 cells x 6 tets
SDF_RADIUS = 0.6
MT_VERT_ATOL = 1e-6
TET_LOSS_RTOL = 1e-5
TET_GRAD_REL = 1e-4

# SPC pipeline (BASELINE config #3, as bench.py::_phase_spc runs it)
SPC_RADIUS = 0.45           # the sphere scaled to ~fox's 992k level-10 voxels
SPC_LEVEL = 10
SPC_PARITY_LEVEL = 8        # device vs host builder (host: numpy float64)
SPC_CAPS = (2 ** 22, 2 ** 23)
RAY_SIDE = 1024             # 1,048,576 camera rays in 4 x 4 pixel blocks
CELLS = dict(cell_shift=3, cell_width=192)
TAU = 0.25                  # optical thickness per voxel hit (opacity check)
DENSE = dict(level=6, points=250_000, side=128, knum=128, seed=6)
FOX = ('fox.obj (bench.py): 992k voxels at level 10, <= 179 hits per ray; '
       'its non-saturating caps allow <= 8192 active blocks and <= 192 '
       'candidate cells per block')
# float32 operations per pair, counted from csrc/dibr_fused.cu (bounds);
# only the pairs where the function needs them
K1_COVER_FLOPS = 35   # (pixel, valid face) in the face's own box (a pixel
#                       outside it is never covered): 5 affine forms, the
#                       sign tests, z
K1_MASK_FLOPS = 87    # (pixel, face) in the face's enlarged bbox (outside
#                       it p = 0): 6 distance candidates, their min, exp,
#                       the product
K2_FLOPS = 125        # (face, pixel) in the bbox where g*prod != 0: the
#                       candidates, exp, dL/dd, the argmin, 4-6 gradient terms
# float32 operations per entry of E1-E3, counted from csrc/epilogue.cu
E1_FLOPS = 11         # (pixel, channel): 4 taps x 2 products, 3 sums
E2_FLOPS = 22         # (pixel, channel): dx, dy (12) and 4 taps x (w * g, +)
E3_FLOPS = 1          # (row, column): one sum
# float32 operations per (beam, box) test of C1, counted from
# csrc/spc_cull.cu: per axis two subtractions, two divisions, two max, two min
C1_FLOPS = 24
# the TPU kernels the probes replace (def lines in the scripts)
P1_LINES = dict(kA=61, kB=73, kC=97, kD=119, kE=144, kF=153, kG=162, kH=174)
# acceptance limits
BORDER_SLACK = 1e-5         # face_idx flips only where a triangle grazes
BARY_ATOL = 1e-5
GRAZING = 1e-5              # trace-only hits must span less than this
BFS_DEPTH_ATOL = 1e-6
OPACITY_ATOL = 1e-5
# path A (phase 17): a pinhole camera 1.49 from the sphere's centre, 14
# degrees off the z axis, sees the sphere fill ~45 % of its pixels at a 45
# degree fov
CAMERA = dict(eye=(0.3, 0.2, 1.45), at=(0., 0., 0.), up=(0., 1., 0.),
              fov=math.radians(45))
IMAGE = 1024
FEAT_DIM = 16
FEAT_SEEDS = (17, 18)       # trained and target corner features
FEAT_LR = 1e-2
# the mid-depth samples need exit depths.  TRACE's caps were sized for
# parallel rays; this camera's diverging rays give fatter interval beams
# (this scene on the H100: up to 882 candidate cells per super-tile against
# TRACE's 512, up to 63 per block, 16,698 non-empty blocks against the
# 4,096 that TRACE's segments give more than 4 cells), so path A cuts no
# candidate: 1,024 cells per super-tile, 128 per block, every block
NG_TRACE = dict(TRACE, with_exit=True, segments=((None, 128),),
                max_super_voxels=192 * 1024,
                max_active_blocks=(IMAGE * IMAGE) // TRACE['rays_per_tile'])
NG_STEP0 = 128              # step 0 on the card against the CPU
# at 128^2 a block spans 8 x 8 times the pixels and a super-tile 15 image
# rows: no cut at all
NG_STEP0_TRACE = dict(NG_TRACE, segments=((None, 2 ** 16),),
                      max_super_voxels=192 * 2 ** 16)
NG_LOSS_RTOL = 1e-5
NG_GRAD_REL = 1e-3          # the optical thickness's gradient is a sample's
#                             own term less the sum over the samples behind
#                             it: it cancels, as phase 4's gradients do
# path B (phase 18)
CONV_SEED = 19
CONV_PARITY_LEVEL = 7       # the stack on the card against the CPU
CONV_OUT_REL = 1e-5
CONV_GRAD_REL = 1e-4        # the weight gradients sum over every point
DENSE_LEVEL = 7
VOXEL_RES = 128
# path C (phase 19): SG light recovery on the DIB-R cell's sphere
IMAGE_C = 512
SG_LOBES = 32
SG_FOV = math.radians(70.)
SG_EYE_DIST = 2.2           # the unit sphere fills ~40 % of a 70 deg view
SG_ELEVATION = 0.35
SG_ROUGHNESS = 0.3
SG_SPEC = 0.04
SG_LR = 5e-2
SG_SEED = 21
SG_STEP0 = dict(image=128, views=1)
SG_MAP_ATOL = 1e-5          # uv / normal / position maps, card vs CPU
SG_LOSS_RTOL = 1e-5
SG_GRAD_REL = 1e-4
# path D (phase 20): DMTet chamfer fit
DMTET_GRID = 64             # 1,572,864 tets: phase 16's count, no subdivision
DMTET_RADIUS = 0.25
DMTET_ELLIPSOID = (0.35, 0.25, 0.30)
DMTET_ELLIPSOID_MESH = (200, 101)   # 40,000 faces
DMTET_TARGET = 100_000
DMTET_SAMPLES = 50_000
DMTET_LAP_W = 0.1
DMTET_LR = 5e-3
DMTET_SEED = 22
DMTET_P2M = 20_000
DMTET_STEP0_GRID = 16
DMTET_STEP0_SAMPLES = 4096
DMTET_STEP0_TARGET = 10_000
DMTET_LOSS_RTOL = 1e-5
DMTET_GRAD_REL = 1e-4
# path E (phase 21): occupancy evaluation
OCC_RES = 128
OCC_RADIUS = 0.45
OCC_PARITY_RES = 32
OCC_SHELL = 1e-3            # the 10,000-face sphere lies within 4.4e-4 of
#                             the true one: farther points are decided
OCC_SAMPLES = 50_000
OCC_FSCORE_RADIUS = 0.02    # 2.6 voxels; 50,000 samples lie ~0.007 apart
OCC_SEED = 23
OCC_IOU_MIN = 0.9           # the vertex voxelization rounds outwards


def _bound(nbytes, flops):
    ms, by = bound_ms(nbytes, flops)
    return dict(bound_ms=ms, bound_by=by)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f'chip_smoke: check failed: {what}')


def toolchain(card):
    """Phase 1: what the machine has; builds the kernels."""
    print(f'card: {card}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} device(s), '
          f'device 0 = {torch.cuda.get_device_name(0)}, '
          f'capability {torch.cuda.get_device_capability(0)}')
    nvcc = _cuda.find_nvcc()
    ver = subprocess.run([nvcc, '--version'], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(f'nvcc: {nvcc}: {ver.strip().splitlines()[-1]}')
    try:
        import triton
        print(f'triton {triton.__version__} imports')
    except ImportError as exc:
        print(f'triton does not import: {exc}')
    # path G uses neither: its views are .npy + JSON, dash3d's messages are
    # built without the server
    for name in ('PIL', 'tornado'):
        found = importlib.util.find_spec(name) is not None
        print(f'{name} {"is" if found else "is not"} installed')
    # a source with Python entry points is built with them (the kernels'
    # route); one nvcc each, all at once
    modules = sorted(p.stem[:-len('_module')]
                     for p in _cuda.CSRC.glob('*_module.cpp'))
    names = sorted(p.stem for p in _cuda.CSRC.glob('*.cu')
                   if p.stem not in modules)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + len(modules)) as pool:
        builds = ([pool.submit(_cuda.load, n) for n in names]
                  + [pool.submit(_cuda.load_module, m) for m in modules])
        for b in builds:
            b.result()
    print(f'kernel builds + loads, in parallel '
          f'({", ".join(n + ".cu" for n in names) or "no plain library"}; '
          f'extension modules '
          f'{", ".join(f"{m}.cu + {m}_module.cpp" for m in modules)}): '
          f'{time.perf_counter() - t0:.2f} s')
    for name in names + [f'{m}_module' for m in modules]:
        for line in _cuda.BUILD_LOG.get(name, '').splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print(f'  ptxas: {line.strip()}')
    t0 = time.perf_counter()
    _native.get_lib()
    print(f'host library (g++ {" ".join(_native.CXX_FLAGS)}: '
          f'{", ".join(_native.SOURCES)}) build + load: '
          f'{time.perf_counter() - t0:.2f} s')


def make_scene(dev, height=HEIGHT, views=VIEWS, texture_res=TEXTURE_RES,
               sphere=SPHERE, backend='fused', knum=KNUM, mesh=None):
    """The trainer's inputs: targets from the unperturbed mesh (``mesh``, an
    imported SurfaceMesh, else ``uv_sphere(*sphere)``) with a numpy-seeded
    texture; the start point perturbed by 0.05 N(0, 1)."""
    if mesh is None:
        s = uv_sphere(*sphere)
        faces = torch.as_tensor(s.faces, device=dev)
        face_uvs = torch.as_tensor(s.uvs[s.face_uvs_idx], device=dev)
        mesh = s
    else:
        faces, face_uvs = mesh.faces.to(dev), mesh.face_uvs.to(dev)
    cams = M.make_views(views, device=dev)
    params = M.init_params(mesh, texture_res, device=dev)
    tex = np.random.default_rng(7).random(
        (3, texture_res, texture_res), dtype=np.float32)
    gt = M.from_jax_params(params.vertices.detach().cpu().numpy(), tex,
                           params.sh_coeffs.detach().cpu().numpy(),
                           device=dev)
    with torch.no_grad():
        sel = M.compute_selection(gt, cams, faces, height, height,
                                  backend=backend, knum=knum)
        target_images, target_masks, _ = M.render_views(
            gt, cams, faces, face_uvs, height, height, backend=backend,
            selection=sel, knum=knum)
        noise = np.random.default_rng(0).standard_normal(
            tuple(params.vertices.shape)).astype(np.float32)
        params.vertices += 0.05 * torch.as_tensor(noise, device=dev)
    return dict(faces=faces, face_uvs=face_uvs, views=cams, params=params,
                target_images=target_images, target_masks=target_masks,
                height=height, backend=backend, knum=knum)


def kernel_inputs(scene):
    """build_face_tiles of the start point, as compute_selection makes it."""
    H = scene['height']
    with torch.no_grad():
        fvc, fvi, fn = M._prepare(scene['params'], scene['views'],
                                  scene['faces'])
        vt, tr, ctr, cbb, _, _ = FU.build_face_tiles(
            fvc[..., 2], fvi * MULT, fn[..., 2] >= 0., H, H, MULT,
            BOXLEN * MULT)
    return vt.float().contiguous(), tr, ctr, cbb.float().contiguous()


def check_forward(scene, inputs):
    """Phase 2: K1 against its plain version."""
    H = scene['height']
    vt, tr, _, cbb = inputs
    fid_k, prod_k = FU._fused_forward_cuda(vt, tr, cbb, H, H, MULT, EPS,
                                           SIGMAINV, True)
    torch.cuda.synchronize()
    fid_p, prod_p = FU._fused_forward_torch(vt, tr, cbb, H, H, MULT, EPS,
                                            SIGMAINV, True)
    torch.cuda.synchronize()
    mismatch = (fid_k != fid_p).float().mean().item()
    dprod = (prod_k - prod_p).abs().max().item()
    mask_k = torch.where(fid_k < 0, 1. - prod_k, 1.)
    mask_p = torch.where(fid_p < 0, 1. - prod_p, 1.)
    dmask = (mask_k - mask_p).abs().max().item()
    covered = (fid_k >= 0).float().mean().item()
    print(f'K1 fused_forward_kernel vs plain: face_idx mismatch share '
          f'{mismatch:.3e} (limit {K1_FID_MISMATCH_MAX:g}), max|dprod| '
          f'{dprod:.3e} (limit {K1_PROD_MAX:g}), soft mask max|d| '
          f'{dmask:.3e}; covered pixels {covered:.4f}, '
          f'chunks {vt.shape[1]}')
    _check(covered > 0.01, 'the scene covers some pixels')
    _check(mismatch <= K1_FID_MISMATCH_MAX, 'K1 face_idx mismatch share')
    _check(dprod <= K1_PROD_MAX, 'K1 max |dprod|')
    _check(torch.isfinite(prod_k).all().item(), 'K1 prod finite')
    return fid_k, prod_k, dprod


def check_backward(scene, inputs, fid, prod):
    """Phase 3: K2 against its plain version, g numpy-seeded."""
    H = scene['height']
    vt, _, ctr, cbb = inputs
    g = torch.as_tensor(np.random.default_rng(1).standard_normal(
        tuple(fid.shape)).astype(np.float32), device=fid.device)
    g_prod = torch.where(fid < 0, g * prod, 0.).contiguous()
    out_k = FU._fused_backward_cuda(vt, ctr, cbb, g_prod, H, H, MULT,
                                    SIGMAINV)
    torch.cuda.synchronize()
    out_p = FU._fused_backward_torch(vt, ctr, cbb, g_prod, H, H, MULT,
                                     SIGMAINV)
    torch.cuda.synchronize()
    scale = out_p.abs().max().item()
    err = (out_k - out_p).abs().max().item()
    print(f'K2 fused_backward_kernel vs plain: max|d| {err:.3e}, '
          f'max|grad| {scale:.3e}, ratio {err / max(scale, 1e-30):.3e} '
          f'(limit {K2_REL_MAX:g})')
    _check(scale > 0, 'K2 gradient is not all zero')
    _check(torch.isfinite(out_k).all().item(), 'K2 output finite')
    _check(err <= K2_REL_MAX * scale, 'K2 max |d| / max |grad|')
    return g_prod, err


def culling(scene, inputs, g_prod):
    """Phase 3, continued: the work K1 and K2 cull to, counted in torch
    from their rules (``_fused._cull_forward``, ``_fused._cull_backward``)
    on this run's inputs."""
    H = scene['height']
    vt, tr, ctr, cbb = inputs
    B, nC = vt.shape[:2]
    _, _, TW = FU._tile_dims(*FU._padded_dims(H, H))
    _, _, bounds = FU._tile_pixels(H, H, MULT, vt.device)
    c = torch.arange(nC, device=vt.device)
    visits = sum(int((FU._chunk_hits_tile(cbb[b], bounds) & (c >= tr[b, :, :1])
                      & (c < tr[b, :, 1:])).sum()) for b in range(B))
    lists = FU._cull_forward(vt, tr, cbb, H, H, MULT).sum(-1)
    busy = lists[lists > 0].float()
    visited, computed, nonzero = FU._cull_backward(ctr, cbb, g_prod, H, H,
                                                   MULT)
    res = dict(k1_pairs=int(lists.sum()) * FU._SUB ** 2,
               k1_tile_pairs=visits * FU.FC * FU.PS * TW,
               list_max=int(lists.max()), list_mean=busy.mean().item(),
               subtiles=lists.numel(), empty=int((lists == 0).sum()),
               k2_units=nonzero.numel(), k2_active=int(nonzero.sum()),
               k2_visited=int(visited.sum()), k2_computed=int(computed.sum()),
               k2_chunk_max=int(computed.sum(-1).max()))
    print(f'K1 culling: {res["k1_pairs"]} (pixel, face) pairs evaluated by '
          f'{FU._SUB} x {FU._SUB} sub-tiles, against {res["k1_tile_pairs"]} '
          f'for one CTA per {FU.PS} x {TW} tile walking every face of each '
          f'visited chunk ({visits} (tile, chunk) visits); face list per '
          f'sub-tile max {res["list_max"]}, mean {res["list_mean"]:.2f} '
          f'over the {lists.numel() - res["empty"]} non-empty of '
          f'{lists.numel()} (sub-tile, view) CTAs')
    print(f'K2 culling: {res["k2_active"]} of {res["k2_units"]} (8-row unit, '
          f'view) sub-tiles hold a pixel with g*prod != 0; (chunk, unit) '
          f'pairs visited {res["k2_visited"]}, computed on '
          f'{res["k2_computed"]}; at most {res["k2_chunk_max"]} per chunk, '
          f'so at most {-(-res["k2_chunk_max"] // FU._BWD_SLICES)} per CTA')
    return res


def check_epilogue(scene, card):
    """Phase 3, continued: E1-E3 on the DIB-R cell's own inputs, E2's and
    E3's those of one eager step from the start point and E1's those of
    ``render_views`` there (the step's albedo is the shading kernel's, from
    E1's taps; kept by :func:`kept_launches`): each against its plain
    version, each run twice more for the same bits,
    and two whole eager steps' gradients compared bit for bit; their times
    by both timers (``time_ms``, ``measure.device_ms``) in turns with one
    PyTorch call of the same function (``grid_sample``,
    ``grid_sampler_2d_backward``, ``index_add_`` into zeros), the plain
    versions, the autograd indexing backward that E3 replaces
    (``index_put_(accumulate=True)``) and the stable sorts alone; each
    kernel's bound on these inputs.  These launches are not path
    launches."""
    twin = _twin(scene['params'])
    saved = read_launches(tuple(COUNTS))
    H = scene['height']
    with kept_launches() as kept:
        _, sel = _step(scene, twin)
        with torch.no_grad():
            M.render_views(twin, scene['views'], scene['faces'],
                           scene['face_uvs'], H, H, selection=sel)
        torch.cuda.synchronize()
    grads = [p.grad.clone() for p in twin.parameters()]
    _step(scene, twin)
    step_bits = all(torch.equal(_bits(a), _bits(p.grad))
                    for a, p in zip(grads, twin.parameters()))
    held, err = hold_against_plain(kept, 'E1-E3 on the DIB-R cell')
    _check(all(held[k] == 1 for k in EPILOGUE),
           'one launch of each of E2, E3 in the DIB-R step and of E1 in '
           'render_views')
    args = {k: kept[k][0][0] for k in EPILOGUE}
    outs = {k: kept[k][0][2] for k in EPILOGUE}
    kern = {k: (lambda k=k: getattr(*HELD[k][:2])(*args[k]))
            for k in EPILOGUE}
    same = {}
    for k in EPILOGUE:
        ref = outs[k] if isinstance(outs[k], tuple) else (outs[k],)
        runs = [kern[k]() for _ in range(2)]
        same[k] = all(torch.equal(_bits(a), _bits(b)) for run in runs
                      for a, b in zip(run if isinstance(run, tuple)
                                      else (run,), ref))
    tex_rows, x, y, hw = args['sample']
    TH, TW, B, P = hw
    Q, R, C = x.shape[0], tex_rows.shape[0], tex_rows.shape[1]
    # E2 in the step: every view's pixels as one batch of the one texture
    R2, x2, y2 = (args['sample_bwd'][0].shape[0], args['sample_bwd'][1],
                  args['sample_bwd'][2])
    g = args['sample_bwd'][3]
    gs, idx, N = args['scatter']
    D = gs.shape[1]
    tex_img = tex_rows.reshape(B, TH, TW, C).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([(x + 0.5) * (2. / TW) - 1.,
                        (y + 0.5) * (2. / TH) - 1.], -1).reshape(B, 1, P, 2)
    g_img = g.reshape(B, 1, P, C).permute(0, 3, 1, 2).contiguous()
    lib = {'sample': lambda: torch.nn.functional.grid_sample(
               tex_img, grid, mode='bilinear', padding_mode='border',
               align_corners=False),
           'sample_bwd': lambda: torch.ops.aten.grid_sampler_2d_backward(
               g_img, tex_img, grid, 0, 1, False, [True, True]),
           'scatter': lambda: torch.zeros((N, D), device=gs.device)
           .index_add_(0, idx, gs)}
    lib_out = lib['sample']()[:, :, 0].permute(0, 2, 1).reshape(Q, C)
    lib_err = (lib_out - outs['sample']).abs().max().item()
    keys = torch.cat(SA._flat_corner_idx(x2, y2, TH, TW, 1, Q)[0])
    sort_ms = {
        'sample_bwd': measure.device_ms(lambda: torch.sort(keys, stable=True),
                                        20),
        'scatter': measure.device_ms(lambda: torch.sort(idx, stable=True),
                                     20)}
    put_ms = measure.device_ms(lambda: torch.zeros(
        (N, D), device=gs.device).index_put_((idx.long(),), gs,
                                             accumulate=True), 3)
    nbytes = {'sample': 4 * (R * C + 2 * Q + Q * C),
              'sample_bwd': 4 * (2 * R2 * C + 4 * Q + Q * C),
              'scatter': 4 * (gs.numel() + idx.numel() + N * D)}
    flops = {'sample': E1_FLOPS * Q * C, 'sample_bwd': E2_FLOPS * Q * C,
             'scatter': E3_FLOPS * gs.numel()}
    runs = {'sample_bwd': int(torch.bincount(keys).max()),
            'scatter': int(torch.bincount(idx).max())}
    rows = {}
    for k in EPILOGUE:
        ms, lib_ms = measure.in_turns(time_ms, kern[k], lib[k], 20)
        dev_ms, lib_dev_ms = measure.in_turns(measure.device_ms, kern[k],
                                              lib[k], 20)
        rows[k] = dict(ms=ms, device_ms=dev_ms, library_ms=lib_ms,
                       library_device_ms=lib_dev_ms,
                       plain_ms=time_ms(lambda k=k: HELD[k][2](*args[k]), 3),
                       max_abs_err=err[k], same_bits=same[k],
                       **_bound(nbytes[k], flops[k]))
    for k, v in saved.items():
        COUNTS[k][k] = v
    print(f'E1-E3 on the DIB-R cell\'s step (E1 render_views\'): textures '
          f'(B*H*W, C) = ({R}, {C}) for E1, ({R2}, {C}) for E2, {Q} pixels, '
          f'face table ({N}, {D}); the longest run of one '
          f'id: {runs["sample_bwd"]} of the {4 * Q} texel taps, '
          f'{runs["scatter"]} of the {idx.numel()} face rows; against '
          f'plain: max abs err {err}; E1-E3 run twice more on the same '
          f'inputs, the same bits: {same}; two whole eager steps\' '
          f'gradients the same bits: {step_bits}; grid_sample against E1 '
          f'max|d| {lib_err:.3e}')
    _check(all(same.values()), 'E1-E3 give the same bits on every run')
    _check(lib_err <= 1e-5, 'grid_sample computes E1\'s function')
    names = dict(sample='E1 bilinear_forward_kernel',
                 sample_bwd='E2 bilinear_pixels_kernel + stable sort + '
                            'segment sums',
                 scatter='E3 stable sort + segment sums')
    libs = dict(sample='grid_sample', sample_bwd='grid_sampler_2d_backward',
                scatter='index_add_ into zeros')
    for k in EPILOGUE:
        r = rows[k]
        print(f'[{card}] {names[k]}: {r["ms"]:.4f} ms per call, '
              f'{r["device_ms"]:.4f} ms on the device; {libs[k]} '
              f'{r["library_ms"]:.4f} / {r["library_device_ms"]:.4f} ms (in '
              f'turns); plain {r["plain_ms"]:.4f} ms; bound '
              f'{r["bound_ms"]:.4f} ms ({r["bound_by"]})'
              + (f'; of it the stable sort alone {sort_ms[k]:.4f} ms on the '
                 f'device' if k in sort_ms else ''))
    print(f'[{card}] the autograd indexing backward E3 replaces '
          f'(index_put_(accumulate=True), indexing_backward_kernel) on the '
          f'same ids: {put_ms:.4f} ms on the device')
    for k in sort_ms:
        rows[k]['sort_device_ms'] = sort_ms[k]
    rows['scatter']['index_put_device_ms'] = put_ms
    return rows, step_bits


def _shade_leaves(scene):
    """The shading's inputs on ``scene``'s start point, its differentiable
    ones as leaves: (face ids, corners, normals, face uvs, texture, SH, soft
    mask, target images, target masks)."""
    params, H = scene['params'], scene['height']
    sel = M.compute_selection(params, scene['views'], scene['faces'], H, H)
    with torch.no_grad():
        _, fvi, fn = M._prepare(params, scene['views'], scene['faces'])
        soft = M._soft_mask(fvi, sel, True, M._SIGMAINV, scene['knum'])
    leaf = [t.detach().clone().requires_grad_() for t in (
        fvi, fn, params.texture_map, params.sh_coeffs, soft)]
    return (sel[0], leaf[0], leaf[1], scene['face_uvs'], leaf[2], leaf[3],
            leaf[4], scene['target_images'], scene['target_masks'])


def _shade_run(fn, args):
    """The loss terms of ``fn`` (the shading or its plain version) on
    ``args`` and the gradients of their sum to the leaves."""
    leaves = [a for a in args if torch.is_tensor(a) and a.requires_grad]
    for t in leaves:
        t.grad = None
    terms = fn(*args)
    (terms[0] + terms[1]).backward()
    return [t.detach() for t in terms], [t.grad.clone() for t in leaves]


def _per_pixel_cats(scene):
    """The ``cat`` and ``stack`` calls of one eager step, forward and
    backward, with an input of a value a pixel or more (B * H * W): (op,
    input shapes) each (the parent's step stacked the SH bands and the
    barycentric weights)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    pixels = scene['views'].camera_rot.shape[0] * scene['height'] ** 2
    ops = (torch.ops.aten.cat.default, torch.ops.aten.stack.default)

    class Cats(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in ops and any(t.numel() >= pixels for t in args[0]):
                self.seen.append((str(func),
                                  [tuple(t.shape) for t in args[0]]))
            return func(*args, **(kwargs or {}))
    twin = _twin(scene['params'])
    with Cats() as mode:
        _step(scene, twin)
    return mode.seen


def check_shade(scene, card):
    """Phase 3, continued: the shading (``render/mesh/_shade.py``, the
    kernels of ``csrc/shade.cuh``) against its plain version, the PyTorch
    composition (with E1-E3), on the DIB-R cell's start point: the loss
    terms within SHADE_LOSS_RTOL, the gradients to the corners, the
    normals, the texture, the SH and the soft mask within SHADE_GRAD_REL of
    their largest; the kernels run again for the same bits; each kernel's
    device time beside its bound and the plain version's, and the whole
    Function's forward and backward (with E2 and E3) beside the plain
    composition's; no ``cat`` or ``stack`` over per-pixel data left in the
    step.  These launches are not path launches."""
    saved = read_launches(tuple(COUNTS))
    args = _shade_leaves(scene)
    names = ('corners', 'normals', 'texture', 'sh', 'soft mask')
    terms_k, grads_k = _shade_run(SH.shade_loss, args)
    terms_p, grads_p = _shade_run(SH._shade_loss_torch, args)
    again = _shade_run(SH.shade_loss, args)
    same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(
        terms_k + grads_k, again[0] + again[1]))
    rel = [abs(a.item() - b.item()) / abs(b.item())
           for a, b in zip(terms_k, terms_p)]
    g_rel = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
             for a, b in zip(grads_k, grads_p)]
    print(f'the shading against plain on the DIB-R cell\'s start point: loss '
          f'terms (image, mask) {[t.item() for t in terms_k]} against '
          f'{[t.item() for t in terms_p]} (rel {rel[0]:.2e}, {rel[1]:.2e}, '
          f'limit {SHADE_LOSS_RTOL:g}); gradients max|d| / max|g| '
          + ', '.join(f'{n} {x:.2e}' for n, x in zip(names, g_rel))
          + f' (limit {SHADE_GRAD_REL:g}); run again, the same bits: {same}')
    _check(all(r <= SHADE_LOSS_RTOL for r in rel), 'shading loss terms '
           'against plain')
    _check(all(x <= SHADE_GRAD_REL for x in g_rel), 'shading gradients '
           'against plain')
    _check(same, 'the shading gives the same bits on every run')

    fid, fvi, fn, uvs, tex, sh, soft, timg, tmask = args
    hw = tuple(tex.shape[1:])
    tex_rows = tex.detach().permute(1, 2, 0).reshape(-1, 3).contiguous()
    inputs = (fid, fvi.detach(), fn.detach(), uvs, tex_rows, sh.detach(),
              soft.detach(), timg, tmask)
    _, _, iou = SH._shade_forward_cuda(inputs, hw)
    one = torch.ones((), device=fid.device)
    fwd_ms = measure.device_ms(lambda: SH._shade_forward_cuda(inputs, hw),
                               20)
    bwd_ms = measure.device_ms(lambda: SH._shade_backward_cuda(
        inputs, iou, one, one, hw), 20)
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: SH._shade_loss_torch(*args), 5)
    whole_ms, plain_ms = measure.in_turns(
        time_ms, lambda: _shade_run(SH.shade_loss, args),
        lambda: _shade_run(SH._shade_loss_torch, args), 5)
    Q, B, F = fid.numel(), fid.shape[0], fvi.shape[1]
    tables = 4 * (B * F * 9 + F * 6 + tex_rows.numel() + 9)
    reads = 4 * Q * (1 + 1 + 3 + 1) + tables   # ids, soft, targets
    nbytes = {'shade': reads + 4 * (B * 2 + 2),
              'shade_bwd': reads + 4 * B * 2 + 4 * Q * (3 + 2 + 9 + 1 + 1)}
    rows = {'shade': dict(ms=fwd_ms, plain_ms=plain_fwd_ms,
                          **_bound(nbytes['shade'], 0)),
            'shade_bwd': dict(ms=bwd_ms, plain_ms=plain_ms - plain_fwd_ms,
                              **_bound(nbytes['shade_bwd'], 0))}
    for k, r in rows.items():
        r['max_abs_err'] = max((a - b).abs().max().item()
                               for a, b in zip(grads_k, grads_p)) \
            if k == 'shade_bwd' else max(abs(a.item() - b.item())
                                         for a, b in zip(terms_k, terms_p))
    cats = _per_pixel_cats(scene)
    print(f'cat / stack calls over per-pixel data in one eager step: '
          f'{cats or "none"}')
    _check(not cats, 'no cat or stack over per-pixel data in the step')
    for k, v in saved.items():
        COUNTS[k][k] = v
    print(f'[{card}] shade_forward_kernel + shade_loss_kernel '
          f'{fwd_ms:.4f} ms on the device, bound '
          f'{rows["shade"]["bound_ms"]:.4f} ms ({nbytes["shade"]} bytes); '
          f'the plain forward {plain_fwd_ms:.4f} ms')
    print(f'[{card}] shade_backward_kernel + shade_sh_kernel {bwd_ms:.4f} ms '
          f'on the device, bound {rows["shade_bwd"]["bound_ms"]:.4f} ms '
          f'({nbytes["shade_bwd"]} bytes); the plain backward '
          f'{plain_ms - plain_fwd_ms:.4f} ms')
    print(f'[{card}] the shading\'s forward and backward with E2 and E3 '
          f'{whole_ms:.4f} ms, the plain composition\'s {plain_ms:.4f} ms '
          f'(in turns, CUDA events)')
    return rows


def _step(scene, params, selection=None):
    """compute_selection -> render_loss -> backward; returns the loss."""
    H = scene['height']
    kw = dict(backend=scene['backend'], knum=scene['knum'])
    sel = M.compute_selection(params, scene['views'], scene['faces'], H, H,
                              **kw)
    for p in params.parameters():
        p.grad = None
    loss = M.render_loss(params, scene['views'], scene['faces'],
                         scene['face_uvs'], scene['target_images'],
                         scene['target_masks'], H, H,
                         selection=sel if selection is None else selection,
                         **kw)
    loss.backward()
    return loss, sel


def check_step_against_plain(scene):
    """Step 0 of ``scene`` (a reduced size) on the card and on the CPU,
    where the wrappers run the plain versions: loss and gradients of the
    kernel path must match the plain path's."""
    params = scene['params']
    loss, sel = _step(scene, params)
    torch.cuda.synchronize()
    cpu = {k: (v.detach().cpu() if torch.is_tensor(v) else v)
           for k, v in scene.items()}
    cpu['views'] = M.CameraViews(*(v.cpu() for v in scene['views']))
    p_cpu = M.from_jax_params(*(p.detach().cpu().numpy() for p in (
        params.vertices, params.texture_map, params.sh_coeffs)),
        device='cpu')
    t0 = time.perf_counter()
    loss_c, sel_c = _step(cpu, p_cpu)
    cpu_s = time.perf_counter() - t0
    H, B = scene['height'], scene['views'].camera_rot.shape[0]
    mism = (sel[0].cpu() != sel_c[0]).float().mean().item()
    rel_loss = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
    print(f'step 0 ({scene["backend"]}, {B} view(s), {H}x{H}), card vs '
          f'plain path on the CPU ({cpu_s:.2f} s on the CPU): loss '
          f'{loss.item():.7f} vs {loss_c.item():.7f} (rel {rel_loss:.2e}, '
          f'limit {STEP0_LOSS_RTOL:g}); face_idx mismatch share {mism:.2e}')
    _check(rel_loss <= STEP0_LOSS_RTOL, 'step-0 loss card vs plain')
    for name in ('vertices', 'texture_map', 'sh_coeffs'):
        g = getattr(params, name).grad.cpu()
        g_c = getattr(p_cpu, name).grad
        scale = g_c.abs().max().item()
        err = (g - g_c).abs().max().item()
        print(f'  grad {name}: max|d| {err:.3e}, max|g| {scale:.3e}, '
              f'ratio {err / max(scale, 1e-30):.2e} '
              f'(limit {STEP0_GRAD_REL:g})')
        _check(scale > 0 and err <= STEP0_GRAD_REL * scale,
               f'step-0 grad {name} card vs plain')
    return cpu_s


def _adam(params):
    """The trainer's Adam, its update captured in the compiled step (on
    the CPU of a rehearsal, where Adam cannot be capturable, eager)."""
    return torch.optim.Adam(params.parameters(), lr=LR,
                            capturable=params.vertices.is_cuda)


def _twin(params):
    """A copy of the model ``params`` on its device."""
    return M.from_jax_params(*(p.detach().cpu().numpy() for p in (
        params.vertices, params.texture_map, params.sh_coeffs)),
        device=params.vertices.device)


def compiled(scene, params, opt):
    """``M.compiled_step`` of the trainer on ``scene``, a callable of no
    arguments that takes one step (one replay of its CUDA graph)."""
    H = scene['height']
    step = M.compiled_step(params, scene['views'], scene['faces'],
                           scene['face_uvs'], scene['target_images'],
                           scene['target_masks'], H, H, opt,
                           backend=scene['backend'], knum=scene['knum'])

    def call():
        return step(scene['views'], scene['target_images'],
                    scene['target_masks'])
    call.step = step
    return call


def _selected(sel):
    """face_idx and the soft mask's selection state (the fused product, or
    the 'jnp' k-buffer) of a compute_selection output."""
    return sel[0], (sel[1].prod if isinstance(sel[1], FU.FusedSelection)
                    else sel[1])


def train(scene, steps=STEPS):
    """The trainer: ``steps`` Adam steps of the compiled step (one CUDA
    graph replayed a step), held against the eager step + Adam from the
    same parameters: step 0's face ids, soft-mask selection and loss bit
    for bit and its gradients within REPLAY_GRAD_REL (by backend) of their
    largest; every step's loss within step 0's card-vs-CPU limit (later
    steps' gradients are printed); K1, K2, E2 and E3 as launched inside the
    graph against their plain versions on the graph's own inputs (E1 is
    not launched: the shading's kernel takes its taps; the shading is held
    against its plain version by :func:`check_shade`).  Returns (the
    kernels' launches over the replays, the losses, the compiled step, the
    peak memory of its build and replays, E1-E3's max abs errors inside
    the graph)."""
    params = scene['params']
    start = {n: p.detach().clone() for n, p in params.named_parameters()}
    twin, eager = _twin(params), []
    opt_e = _adam(twin)
    for k in range(steps):
        loss, sel = _step(scene, twin)
        eager.append(dict(loss=loss.detach(), sel=[
            x.clone() for x in _selected(sel)],
            grads=[p.grad.clone() for p in twin.parameters()]))
        opt_e.step()
    del twin, opt_e
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with kept_launches() as kept:
        call = compiled(scene, params, _adam(params))
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    zero_launches()
    out = []
    t0 = time.perf_counter()
    for k in range(steps):
        loss = call()
        # kept on the device: nothing is read back inside the loop
        out.append(dict(loss=loss, sel=[x.clone() for x in _selected(
            call.step.selection)], grads=[p.grad.clone()
                                          for p in params.parameters()]))
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f'compiled step ({scene["backend"]}): built in {build_s:.2f} s '
          f'(host clock: {M._WARMUP} warm-up steps, the state put back, '
          f'the capture); {steps} replays in {loop_ms:.1f} ms host clock, '
          f'read once after them; peak allocated over build and replays '
          f'{peak / 2 ** 30:.3f} GiB')
    losses = [o['loss'].item() for o in out]
    for k, (o, e) in enumerate(zip(out, eager)):
        rel = abs(losses[k] - e['loss'].item()) / abs(e['loss'].item())
        g_rel = [(a - b).abs().max().item() / max(b.abs().max().item(),
                                                  1e-30)
                 for a, b in zip(o['grads'], e['grads'])]
        print(f'step {k} ({scene["backend"]}): loss {losses[k]:.7f}, eager '
              f'{e["loss"].item():.7f} (rel {rel:.2e}, limit '
              f'{STEP0_LOSS_RTOL:g}); gradients against eager\'s step {k} '
              f'max|d| / max|g| ' + ', '.join(f'{x:.2e}' for x in g_rel))
        _check(rel <= STEP0_LOSS_RTOL, f'step {k} loss against eager')
        _check(o['grads'][0].abs().max().item() > 0,
               'vertex gradient non-zero')
    o, e = out[0], eager[0]
    same = [torch.equal(_bits(a) if a.is_floating_point() else a,
                        _bits(b) if b.is_floating_point() else b)
            for a, b in zip(o['sel'] + [o['loss']], e['sel'] + [e['loss']])]
    g_rel = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
             for a, b in zip(o['grads'], e['grads'])]
    print(f'step 0, replay against eager from the same parameters: face_idx, '
          f'soft-mask selection, loss bit-equal {same}; gradients max|d| / '
          f'max|g| ' + ', '.join(f'{x:.2e}' for x in g_rel)
          + f' (limit {REPLAY_GRAD_REL[scene["backend"]]:g})')
    _check(all(same), 'step 0: the replay bit-equal to eager')
    _check(all(x <= REPLAY_GRAD_REL[scene['backend']] for x in g_rel),
           'step 0: the replay\'s gradients against eager')
    in_graph = {k: [e for e in v if e[3]] for k, v in kept.items()}
    held, err = hold_against_plain(in_graph, 'K1/K2/E2/E3 inside the graph')
    print(f'K1/K2/E2/E3 as launched inside the graph, on its last replay\'s '
          f'inputs, against plain: {held} held, max abs err {err}')
    fused = scene['backend'] == 'fused'
    _check(held['fwd'] == held['bwd'] == int(fused) and not held['trace']
           and not held['sample']
           and all(held[k] == 1 for k in STEP_EPILOGUE),
           'the graph holds one K1 and one K2 launch (fused), one of each '
           'of E2 and E3 and none of E1')
    print(f'kernel launches during the {steps} replays: {launches}')
    _check(launches == dict(fwd=steps * fused, bwd=steps * fused, sample=0,
                            **{k: steps for k in STEP_EPILOGUE + SHADE}),
           'one K1 and one K2 launch (fused), one of each of E2, E3 and the '
           'shading\'s two kernels counted per replay, none of E1')
    _check(all(np.isfinite(losses)), 'losses finite')
    _check(losses[-1] < losses[0], 'the loss falls')
    for n, p in params.named_parameters():
        _check(torch.isfinite(p).all().item(), f'{n} finite')
        _check(not torch.equal(p.detach(), start[n]), f'{n} moved')
    return launches, losses, call, peak, {k: err[k] for k in EPILOGUE}


def step_profile(step, card, steps=3, top=8, kernels=None):
    """``step()`` on the card's timeline (``torch.profiler`` over ``steps``
    steps after the timed ones): kernels per step, the union of their
    intervals against the host clock (device busy and idle share), and the
    kernels that take the most device time.  Returns the idle share;
    ``kernels``, a dict, gets each kernel's ms per step by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = _cuda.BUILD_DIR / 'step_trace.json'
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    spans = sorted((e['ts'], e['ts'] + e['dur'], e['name']) for e in
                   json.loads(path.read_text())['traceEvents']
                   if e.get('cat') == 'kernel')
    _check(len(spans) > 0, 'the profiler traced the card')
    busy, end, by_name = 0., -np.inf, {}
    for a, b, name in spans:
        busy += max(0., b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.) + (b - a) / 1e3 / steps
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    if kernels is not None:
        kernels.update(by_name)
    print(f'[{card}] step on the timeline ({steps} steps, profiled): '
          f'{len(spans) / steps:.0f} kernels per step, device busy '
          f'{busy / 1e3 / steps:.3f} ms of {wall / steps:.3f} ms per step '
          f'(idle share {1 - busy / 1e3 / wall:.3f}), kernel time '
          f'{sum(by_name.values()):.3f} ms per step; largest: ' + '; '.join(
              f'{n[:48]} {ms:.3f}' for n, ms in heavy))
    return 1 - busy / 1e3 / wall


def times(scene, inputs, g_prod, card, call, peak):
    """Phase 5: the eager step (selection + render_loss + backward +
    Adam, launched from Python) and the compiled step ``call`` (one CUDA
    graph) in turns by ``time_ms``, which reads the host where the host is
    slower, as a caller pays it; the compiled step's device time alone,
    by events around back-to-back replays of its graph (a replay is one
    launch from the host and cannot itself be captured, so
    ``measure.device_ms`` cannot time it); each step on the card's
    timeline; the peak memory of each (``peak``: the compiled step's build
    and replays, from :func:`train`); the kernels beside their plain
    versions."""
    H = scene['height']
    B = scene['views'].camera_rot.shape[0]
    F = scene['faces'].shape[0]
    vt, tr, ctr, cbb = inputs
    params = scene['params']
    opt_e = _adam(params)

    def eager():
        _step(scene, params)
        opt_e.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager()
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    compiled_ms, eager_ms = measure.in_turns(time_ms, call, eager, 5)
    device = time_ms(call.step.graph.replay, 5)
    print(f'[{card}] compiled step: profile')
    prof = {}
    idle_c = step_profile(call, card, top=12, kernels=prof)

    def named(*parts):
        return sum(ms for n, ms in prof.items()
                   if any(p in n for p in parts))
    epi = dict(grid_sampler_ms=named('grid_sampler'),
               indexing_backward_ms=named('indexing_backward'),
               epilogue_kernels_ms=named('bilinear_', 'segment_'),
               sort_ms=named('Radix', 'radix', 'Sort', 'sort'),
               shade_kernels_ms=named('shade::'),
               cat_ms=named('CatArrayBatchedCopy'))
    print(f'[{card}] compiled step, kernels by name (ms per step): '
          f'grid_sampler* {epi["grid_sampler_ms"]:.3f}, '
          f'indexing_backward* {epi["indexing_backward_ms"]:.3f} (what is '
          f'left: index_vertices_by_faces\' backward), E2/E3 (bilinear_*, '
          f'segment_*) {epi["epilogue_kernels_ms"]:.3f}, the stable sorts '
          f'{epi["sort_ms"]:.3f}, the shading (shade::*) '
          f'{epi["shade_kernels_ms"]:.3f}, CatArrayBatchedCopy '
          f'{epi["cat_ms"]:.4f}')
    _check(epi['grid_sampler_ms'] == 0.,
           'grid_sample\'s kernels are gone from the compiled step')
    _check(epi['epilogue_kernels_ms'] > 0., 'E2, E3 run in the compiled step')
    _check(epi['shade_kernels_ms'] > 0., 'the shading runs in the compiled '
           'step')
    print(f'[{card}] eager step: profile')
    idle_e = step_profile(eager, card)
    fwd = (vt, tr, cbb, H, H, MULT, EPS, SIGMAINV, True)
    bwd = (vt, ctr, cbb, g_prod, H, H, MULT, SIGMAINV)
    k1_ms = time_ms(lambda: FU._fused_forward_cuda(*fwd), 20)
    k1_plain_ms = time_ms(lambda: FU._fused_forward_torch(*fwd), 3)
    k2_ms = time_ms(lambda: FU._fused_backward_cuda(*bwd), 20)
    k2_plain_ms = time_ms(lambda: FU._fused_backward_torch(*bwd), 3)
    for what, ms, idle, pk in (
            ('eager step (selection + render_loss + backward + Adam, from '
             'Python)', eager_ms, idle_e, eager_peak),
            ('compiled step (the same, one CUDA graph)', compiled_ms, idle_c,
             peak)):
        print(f'[{card}] {what}, {B} views, {H}x{H}, {F} faces: {ms:.3f} ms '
              f'= {B * H * H / ms / 1e3:.3f} Mpix/s, '
              f'{B * F / ms * 1e3:.0f} triangles/s (in turns); idle share '
              f'{idle:.3f}; peak allocated {pk / 2 ** 30:.3f} GiB')
    print(f'[{card}] compiled step on the device alone (its graph\'s '
          f'replays back to back): {device:.3f} ms = '
          f'{B * H * H / device / 1e3:.3f} Mpix/s')
    print(f'[{card}] K1 fused_forward_kernel {k1_ms:.4f} ms, plain '
          f'{k1_plain_ms:.4f} ms')
    print(f'[{card}] K2 fused_backward_kernel {k2_ms:.4f} ms, plain '
          f'{k2_plain_ms:.4f} ms')
    return dict(step_ms=compiled_ms, eager_ms=eager_ms, device_ms=device,
                k1_ms=k1_ms, k1_plain_ms=k1_plain_ms, k2_ms=k2_ms,
                k2_plain_ms=k2_plain_ms, idle=idle_c, profile=epi)


# ---------------------------------------------------------------------------
# SPC pipeline

def _bits(x):
    """The bits of a float32 tensor, for bitwise comparisons."""
    return x.contiguous().view(torch.int32)


def _same_outputs(a, b):
    """K3 outputs (t_near, t_far, pidx, count): floats bitwise equal."""
    return all(torch.equal(_bits(x), _bits(y)) if x.is_floating_point()
               else torch.equal(x, y) for x, y in zip(a, b))


def _max_t_err(a, b):
    """max |t_near a - t_near b| over the entries finite in both."""
    fin = torch.isfinite(a[0]) & torch.isfinite(b[0])
    return (a[0] - b[0])[fin].abs().max().item() if fin.any() else 0.


def spc_mesh():
    """The scaled sphere: (F, 3, 3) float32 face vertices (numpy)."""
    s = uv_sphere(*SPHERE)
    return (s.vertices * SPC_RADIUS)[s.faces]


def camera_rays(dev):
    """camera_grid(1024), permuted once into 4 x 4 pixel blocks."""
    o, d = camera_grid(RAY_SIDE)
    perm, _ = _block_order(RAY_SIDE, RAY_SIDE, 4, 4)
    return (torch.as_tensor(o[perm], device=dev),
            torch.as_tensor(d[perm], device=dev))


def spc_build(fv, dev):
    """Phase 6: the level-8 device builder against the host builder,
    level-10 builds at two capacities."""
    fv_d = torch.as_tensor(fv, device=dev)
    L = SPC_PARITY_LEVEL
    t0 = time.perf_counter()
    host = unbatched_mesh_to_spc(fv.astype(np.float64), L)
    host_s = time.perf_counter() - t0
    devb = [x.cpu() for x in unbatched_mesh_to_spc_device(
        fv_d, L, cap=SPC_CAPS[0])]
    _check(torch.equal(host[0], devb[0]), f'level-{L} octree device == host')
    _check(torch.equal(host[1], devb[1]), f'level-{L} points device == host')
    diff = host[2] != devb[2]
    vox = host[1][diff].numpy().astype(np.int64)
    tris = fv.astype(np.float64)[torch.minimum(host[2], devb[2])[diff]]
    grazing = bool(_tri_aabb_sat(tris, vox, L, BORDER_SLACK).all()
                   and not _tri_aabb_sat(tris, vox, L, -BORDER_SLACK).any())
    bary_err = (host[3] - devb[3])[~diff].abs().max().item()
    print(f'level {L}, device builder (card) vs host builder (numpy float64,'
          f' {host_s:.1f} s): {host[1].shape[0]} voxels, {host[0].shape[0]} '
          f'octree bytes, bytes and points equal; face_idx equal on '
          f'{int((~diff).sum())} voxels, the other {int(diff.sum())} all '
          f'grazing (lower-id triangle inside the voxel grown by '
          f'{BORDER_SLACK:g}, outside it shrunk by {BORDER_SLACK:g}): '
          f'{grazing}; bary max|d| {bary_err:.3e} (limit {BARY_ATOL:g})')
    _check(grazing, 'face_idx differs only where a triangle grazes')
    _check(diff.float().mean().item() < 0.05, 'face_idx differs on < 5%')
    _check(bary_err <= BARY_ATOL, 'bary device vs host')
    builds = []
    for cap in SPC_CAPS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = unbatched_mesh_to_spc_device(fv_d, SPC_LEVEL, cap=cap)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        print(f'level {SPC_LEVEL}, cap 2^{cap.bit_length() - 1}: '
              f'{out[1].shape[0]} voxels, {out[0].shape[0]} octree bytes, '
              f'build {ms:.1f} ms (host clock, synchronised, first call '
              f'includes warm-up), peak device memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB')
        builds.append(out)
    for a, b, name in zip(*builds, ('octree', 'points', 'face_idx', 'bary')):
        _check(torch.equal(a, b), f'level-{SPC_LEVEL} {name} equal at both '
               'caps (no proposals cut)')


def spc_main_path(fv, dev):
    """The SPC pipeline through its entry points, from the mesh to a per-ray
    opacity; K3's and C1's launch counts are read around it, and C1's
    launch is held against its plain version on the inputs it was given."""
    fv_d = torch.as_tensor(fv, device=dev)
    o, d = camera_rays(dev)
    torch.cuda.synchronize()
    zero_launches(('trace', 'cull'))
    with kept_launches(('cull',)) as kept:
        octree, _, _, _ = unbatched_mesh_to_spc_device(fv_d, SPC_LEVEL,
                                                       cap=SPC_CAPS[0])
        max_level, pyramids, exsum = scan_octrees(octree, [octree.shape[0]])
        ph = generate_points(octree, pyramids, exsum)
        table = build_cell_table(ph, pyramids[0], SPC_LEVEL, **CELLS)
        hits = unbatched_raytrace_coherent(octree, ph, pyramids[0], exsum, o,
                                           d, SPC_LEVEL, engine='mosaic',
                                           cell_table=table, **TRACE)
        ridx, pidx, _ = hits_to_nuggets(hits)
        first = mark_pack_boundaries(ridx)
        ones = torch.ones((ridx.shape[0], 1), device=dev)
        per_ray, _ = exponential_integration(ones, TAU * ones, first)
        opacity = torch.zeros(o.shape[0], device=dev)
        opacity[ridx[first].long()] = per_ray[:, 0]
        torch.cuda.synchronize()
    launches = read_launches(('trace', 'cull'))
    held, err = hold_against_plain(kept, 'SPC main path')

    pyr = pyramids[0]
    V, off = int(pyr[0, SPC_LEVEL]), int(pyr[1, SPC_LEVEL])
    cnt = hits.count
    hit = cnt > 0
    expected = 1. - torch.exp(-TAU * torch.clamp(cnt, max=TRACE['knum']))
    op_err = (opacity - expected).abs().max().item()
    print(f'SPC main path: level {max_level}, {V} voxels, '
          f'{table.rows.shape[0] - 1} cells (overflow {table.overflow}), '
          f'{o.shape[0]} rays, {int(hit.sum())} hit, {int(cnt.sum())} hits, '
          f'max {int(cnt.max())} per ray, saturated {bool(hits.saturated)}; '
          f'opacity max|d| from 1 - exp(-{TAU:g} count) {op_err:.2e} '
          f'(limit {OPACITY_ATOL:g}); K3 launches {launches["trace"]}, C1 '
          f'launches {launches["cull"]}, held against plain bit for bit '
          f'{held["cull"]} (max|d| {err["cull"]})')
    _check(max_level == SPC_LEVEL, 'octree depth')
    _check(table.overflow == 0, 'cell table overflow 0')
    _check(not bool(hits.saturated), 'the sphere trace does not saturate')
    _check(tuple(hits.t_near.shape) == (o.shape[0], TRACE['knum']),
           'k-buffer shape')
    live = hits.pidx >= 0
    _check(torch.equal(live.sum(1, dtype=torch.int32), cnt), 'count = hits')
    _check(bool(torch.isfinite(hits.t_near[live]).all()), 'depths finite')
    _check(bool(((hits.pidx[live] >= off) & (hits.pidx[live] < off + V))
                .all()), 'pidx in the leaf level')
    _check(pidx.shape[0] == int(cnt.sum()), 'nuggets = hits')
    _check(torch.equal(opacity > 0, hit), 'opacity > 0 exactly where hit')
    _check(op_err <= OPACITY_ATOL, 'opacity')
    _check(launches['trace'] >= 1, 'K3 launched on the main path')
    _check(launches['cull'] == held['cull'] == 1,
           'C1 launched once on the main path, and held against plain')
    return dict(octree=octree, pyramid=pyr, exsum=exsum, ph=ph, table=table,
                o=o, d=d, hits=hits, launches=launches['trace'], fv=fv_d,
                cull_launches=launches['cull'], cull_err=err['cull'],
                cull_args=kept['cull'][0][0])


def _trace_args(spc, knum):
    keys = ('rays_per_tile', 'segments', 'max_super_voxels',
            'max_active_blocks')
    return trace_inputs(spc['table'], spc['o'], spc['d'], knum=knum,
                        **{k: TRACE[k] for k in keys})


def check_trace_kernel(spc):
    """Phase 7: K3 against its plain version on every active block of the
    sphere scene, with the main path's settings."""
    args, sat = _trace_args(spc, TRACE['knum'])
    nb, rt = args['nb'], args['rays'].shape[1]
    off = spc['table'].offset
    out_p = _trace._trace_torch(with_exit=False, **args)
    same = True
    for offset in (0, off):
        out_k = _trace._trace_cuda(with_exit=False, pidx_offset=offset,
                                   **args)
        torch.cuda.synchronize()
        moved = torch.where(out_p[2] >= 0, out_p[2] + offset, -1)
        same &= _same_outputs(out_k, (out_p[0], out_p[1], moved, out_p[3]))
    same_plain_off = torch.equal(moved, _trace._trace_torch(
        with_exit=False, pidx_offset=off, **args)[2])
    N = spc['o'].shape[0]
    cnt = out_k[3].reshape(N)
    hit = cnt > 0
    main = spc['hits']
    same_main = (torch.equal(cnt, main.count) and torch.equal(
        _bits(out_k[0].reshape(N, -1)), _bits(main.t_near)))
    err = _max_t_err(out_k, out_p)
    tests = kbisect.trace_work(args, out_k[3], False)[2]
    print(f'K3 spc_trace_kernel vs plain on the sphere scene: '
          f'{int((nb > 0).sum())} active blocks ({nb.shape[0]} traced) of '
          f'{args["num_blocks"]}, candidate cells per active block max '
          f'{int(nb.max())}, mean {nb[nb > 0].float().mean().item():.2f}; '
          f'{rt * args["cell_rows"].shape[2] * int(nb.sum())} (ray, slot) '
          f'pairs, {tests} of them (ray, voxel) slab tests; hits per ray '
          f'max {int(cnt.max())}, mean '
          f'{cnt[hit].float().mean().item():.2f} over the {int(hit.sum())} '
          f'rays that hit; count, pidx and t_near (bitwise) equal with '
          f'pidx offset 0 and {off}: {same}; max|dt| {err:.3e}; same rows '
          f'as the main path: {same_main}; culling saturated {bool(sat)}')
    print(f'  for comparison, {FOX}')
    _check(same, 'K3 equals its plain version on the sphere scene')
    _check(same_plain_off, 'the plain version adds the offset to live pidx')
    _check(same_main, 'the main path went through the same K3 rows')
    _check(not bool(sat), 'culling does not saturate')
    return args, err


def _k3_vs_plain(args, offset, name):
    """K3 against its plain version on ``args``, with pidx offset 0 and
    ``offset``, with and without exit depths; (max |dt|, count)."""
    err = 0.
    for with_exit in (True, False):
        for off in (0, offset):
            out_k = _trace._trace_cuda(with_exit=with_exit, pidx_offset=off,
                                       **args)
            torch.cuda.synchronize()
            out_p = _trace._trace_torch(with_exit=with_exit, pidx_offset=off,
                                        **args)
            torch.cuda.synchronize()
            _check(_same_outputs(out_k, out_p),
                   f'K3 equals its plain version, {name}, with_exit='
                   f'{with_exit}, pidx_offset={off}')
            err = max(err, _max_t_err(out_k, out_p))
    return err, out_k[3]


def check_dense(dev):
    """Phase 8: K3 against its plain version where rays hit more than 64
    voxels and some more than the k-buffer (a dense random level-6 octree,
    rays along the diagonal)."""
    L = DENSE['level']
    rng = np.random.default_rng(DENSE['seed'])
    pts = torch.as_tensor(rng.integers(0, 2 ** L, (DENSE['points'], 3)),
                          device=dev)
    octree = unbatched_points_to_octree(pts, L)
    _, pyramids, exsum = scan_octrees(octree, [octree.shape[0]])
    ph = generate_points(octree, pyramids, exsum)
    table = build_cell_table(ph, pyramids[0], L, cell_shift=2, cell_width=64)
    o, d = camera_grid(DENSE['side'], z=-2.5, spread=0.05, extent=0.3)
    o[:, :2] -= 2.5
    d = d + np.array([1., 1., 0.], np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    kw = dict(rays_per_tile=32, segments=((None, 4096),),
              max_super_voxels=64 * 4096)
    args, sat = trace_inputs(table, o, d, knum=DENSE['knum'], **kw)
    kbuf = args['kbuf']
    err, cnt = _k3_vs_plain(args, table.offset, 'dense')
    # the same scene with voxels taken out of and put into the rows, and
    # every third block without a candidate cell
    odd = dict(args, cell_rows=torch.as_tensor(punch_cell_rows(
        args['cell_rows'].cpu().numpy(), DENSE['seed']), device=dev),
        nb=args['nb'].clone())
    odd['nb'][::3] = 0
    live = odd['cell_rows'][:, 3] >= 0
    fill = (live * torch.arange(1, live.shape[1] + 1, device=dev)).amax(1)
    kinds = dict(full=int(live.all(1).sum()), empty=int((~live.any(1)).sum()),
                 holes=int((live.sum(1) < fill).sum()))
    err_odd, cnt_odd = _k3_vs_plain(odd, table.offset, 'dense with holes')
    print(f'K3 vs plain, the dense octree\'s rows punched: {kinds["holes"]} '
          f'rows with a hole before their last voxel, {kinds["empty"]} '
          f'empty, {kinds["full"]} full (tied depths), '
          f'{int((odd["nb"] == 0).sum())} blocks with nb = 0; hits per ray '
          f'max {int(cnt_odd.max())}, {int((cnt_odd > kbuf).sum())} rays > '
          f'kbuf {kbuf}; equal (bitwise) with both offsets, with and '
          f'without exit depths')
    _check(min(kinds.values()) > 0 and int((cnt_odd > kbuf).sum()) > 0,
           'punched rows of every kind, counts past kbuf')
    err = max(err, err_odd)
    trace = dict(engine='mosaic', cell_table=table, **kw)
    sat_k = unbatched_raytrace_coherent(octree, ph, pyramids[0], exsum, o, d,
                                        L, knum=DENSE['knum'], **trace)
    sat_256 = unbatched_raytrace_coherent(octree, ph, pyramids[0], exsum, o,
                                          d, L, knum=256, **trace)
    print(f'K3 vs plain, dense level-{L} octree ({ph.shape[0]} points): '
          f'{int((args["nb"] > 0).sum())} active blocks, candidate cells '
          f'per block max {int(args["nb"].max())}; hits per ray max '
          f'{int(cnt.max())}, {int((cnt > 64).sum())} rays > 64, '
          f'{int((cnt > kbuf).sum())} > kbuf {kbuf}; equal (bitwise) with '
          f'pidx offset 0 and '
          f'{table.offset}, with and without exit depths; '
          f'saturated at knum {DENSE["knum"]}: {bool(sat_k.saturated)}, '
          f'at knum 256: {bool(sat_256.saturated)}')
    _check(not bool(sat), 'dense culling does not saturate')
    _check(int((cnt > kbuf).sum()) > 0 and int((cnt > 64).sum()) > 0,
           'dense counts exceed 64 and kbuf')
    _check(bool(sat_k.saturated), 'saturated where count > kbuf')
    _check(bool(sat_256.saturated) == bool((sat_256.count > 256).any()),
           'saturated exactly when a count exceeds knum')
    return err, args


def check_against_bfs(spc):
    """Phase 9: the whole trace (with exit depths) against the port's BFS
    on the same 1,048,576 rays: every BFS hit traced, extras only where
    grazing, common depths within BFS_DEPTH_ATOL."""
    args = (spc['octree'], spc['ph'], spc['pyramid'], spc['exsum'],
            spc['o'], spc['d'], SPC_LEVEL)
    hits = unbatched_raytrace_coherent(
        *args, engine='mosaic', cell_table=spc['table'],
        **dict(TRACE, with_exit=True))
    main = spc['hits']
    _check(torch.equal(hits.count, main.count)
           and torch.equal(hits.pidx, main.pidx)
           and torch.equal(_bits(hits.t_near), _bits(main.t_near)),
           'with_exit changes no hit')
    hits_vs_bfs(spc, spc['o'], spc['d'], hits)


def hits_vs_bfs(spc, o, d, hits):
    """A trace's hits (with exit depths) against the port's BFS on the same
    rays: every BFS hit traced, extras only where grazing, common depths
    within BFS_DEPTH_ATOL."""
    args = (spc['octree'], spc['ph'], spc['pyramid'], spc['exsum'], o, d,
            SPC_LEVEL)
    r2, p2, d2 = hits_to_nuggets(hits)
    t0 = time.perf_counter()
    r1, p1, d1, info = unbatched_raytrace(*args, with_exit=True,
                                          return_info=True)
    torch.cuda.synchronize()
    bfs_s = time.perf_counter() - t0
    P = spc['ph'].shape[0]
    k1 = r1.long() * P + p1.long()
    k2 = r2.long() * P + p2.long()
    s2, i2 = torch.sort(k2)
    pos = torch.searchsorted(s2, k1).clamp(max=max(0, s2.shape[0] - 1))
    found = s2[pos] == k1
    j = i2[pos[found]]
    dmax = (d2[j] - d1[found]).abs().max().item() if j.numel() else 0.
    in_bfs = torch.zeros(k2.shape[0], dtype=torch.bool, device=k2.device)
    in_bfs[j] = True
    span = d2[~in_bfs, 1] - d2[~in_bfs, 0]
    span_max = span.max().item() if span.numel() else 0.
    print(f'trace vs BFS ({bfs_s:.2f} s host clock, first call), '
          f'{o.shape[0]} rays: BFS {r1.shape[0]} nuggets (saturated '
          f'{info.saturated}), trace {r2.shape[0]}; BFS hits missing from '
          f'the trace {int((~found).sum())}; trace-only hits '
          f'{span.shape[0]}, max span {span_max:.2e} (limit {GRAZING:g}); '
          f'common depths max|d| {dmax:.2e} (limit {BFS_DEPTH_ATOL:g})')
    _check(not info.saturated, 'BFS did not saturate')
    _check(bool(found.all()), 'every BFS hit is in the trace')
    _check(bool((span < GRAZING).all()), 'extras are grazing')
    _check(dmax <= BFS_DEPTH_ATOL, 'common depths')


def spc_times(spc, args, card):
    """Phase 10: device times (CUDA events) after warm-up."""
    trace_args = (spc['octree'], spc['ph'], spc['pyramid'], spc['exsum'],
                  spc['o'], spc['d'], SPC_LEVEL)
    N = spc['o'].shape[0]
    trace_ms = time_ms(lambda: unbatched_raytrace_coherent(
        *trace_args, engine='mosaic', cell_table=spc['table'], **TRACE), 5)
    # once: the trace as it was before K3 wrote the final pidx
    same_after = _same_outputs(spc['hits'], stages.trace_offset_after(spc))
    after_ms = time_ms(lambda: stages.trace_offset_after(spc), 5)
    launch = {k: v for k, v in args.items() if k != 'num_blocks'}
    out = _trace._outputs(args['num_blocks'], args['rays'].shape[1],
                          args['kbuf'], spc['o'].device)
    off = spc['table'].offset
    k3_ms = time_ms(lambda: _trace._launch(with_exit=False, out=out,
                                            pidx_offset=off, **launch), 20)
    k3_alloc_ms = time_ms(lambda: _trace._trace_cuda(
        with_exit=False, pidx_offset=off, **args), 20)
    k3_plain_ms = time_ms(lambda: _trace._trace_torch(
        with_exit=False, pidx_offset=off, **args), 2)
    cull = spc['cull_args']
    saved = read_launches(('cull',))
    c1_ms = time_ms(lambda: RS._cull_candidates_cuda(*cull), 20)
    c1_plain_ms = time_ms(lambda: RS._cull_candidates_torch(*cull), 3)
    COUNTS['cull'].update(saved)      # these launches are not path launches
    blo, _, o, _, cs, ck_max = cull
    nB, rt = o.shape[:2]
    Mc = blo.shape[0] - 1
    c1_bytes = nB * rt * 24 + nB * (ck_max * 4 + 8) + (Mc + 1) * 24
    c1_flops = C1_FLOPS * (nB // 64 * Mc + nB * cs)
    table_ms = time_ms(lambda: build_cell_table(
        spc['ph'], spc['pyramid'], SPC_LEVEL, **CELLS), 5)
    build_ms = time_ms(lambda: unbatched_mesh_to_spc_device(
        spc['fv'], SPC_LEVEL, cap=SPC_CAPS[0]), 3)
    bfs_ms = time_ms(lambda: unbatched_raytrace(*trace_args,
                                                 with_exit=True), 2)
    print(f'[{card}] trace (culling + K3 + outputs, {N} rays, knum '
          f'{TRACE["knum"]}): {trace_ms:.3f} ms = {N / trace_ms / 1e3:.3f} '
          f'Mrays/s; with the pidx offset as a torch.where pass after K3 '
          f'(K3 at offset 0): {after_ms:.3f} ms, its hits equal to the main '
          f'path\'s bit for bit: {same_after}')
    _check(same_after, 'K3\'s fused offset equals the offset pass after it')
    print(f'[{card}] K3 spc_trace_kernel {k3_ms:.4f} ms (into allocated '
          f'outputs; {k3_alloc_ms:.4f} ms with their allocation and fill), '
          f'plain {k3_plain_ms:.4f} ms')
    c1_bound = _bound(c1_bytes, c1_flops)
    print(f'[{card}] C1 spc_cull_kernel on the main path\'s inputs ({nB} '
          f'blocks of {rt} rays, {Mc} cells, cs {cs}, ck_max {ck_max}): '
          f'{c1_ms:.4f} ms with its outputs\' allocation, plain '
          f'{c1_plain_ms:.4f} ms; bound {c1_bound["bound_ms"]:.4f} ms '
          f'({c1_bound["bound_by"]}: {c1_bytes} bytes, {c1_flops} flops of '
          f'the (beam, box) tests with no early exit)')
    print(f'[{card}] build_cell_table {table_ms:.3f} ms; '
          f'unbatched_mesh_to_spc_device (level {SPC_LEVEL}, cap '
          f'2^{SPC_CAPS[0].bit_length() - 1}) {build_ms:.3f} ms; BFS '
          f'unbatched_raytrace {bfs_ms:.3f} ms')
    print(f'[{card}] peak device memory so far '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB')
    return dict(trace_ms=trace_ms, k3_ms=k3_ms, k3_plain_ms=k3_plain_ms,
                c1_ms=c1_ms, c1_plain_ms=c1_plain_ms, c1_bound=c1_bound)


def dibr_work(scene, inputs, g_prod):
    """(K1 bytes, K1 flops, K2 bytes, K2 flops) on this run's inputs.

    Over the (tile, chunk) visits that pass the bbox test: for K1 the
    (pixel, valid face) pairs inside the face's own box (coverage) and the
    (pixel, face) pairs inside its enlarged bbox (soft mask); for K2 those
    of the enlarged bbox where g*prod != 0.  Each visited chunk's table and
    each image read once, each output written once.
    """
    H = scene['height']
    vt, tr, _, cbb = inputs
    B, nC = vt.shape[:2]
    dev = vt.device
    nI, nJ, TW = FU._tile_dims(*FU._padded_dims(H, H))
    T = nI * nJ
    x0, y0, bounds = FU._tile_pixels(H, H, MULT, dev)
    xcol, yrow = x0[:, :TW], y0[:, ::TW]                  # (T, TW), (T, PS)
    gz = torch.zeros((B, nI * FU.PS, nJ * TW), device=dev)
    gz[:, :H, :H] = (g_prod != 0).float()
    gz = gz.reshape(B, nI, FU.PS, nJ, TW).permute(0, 1, 3, 2, 4).reshape(
        B, T, FU.PS, TW)
    c = torch.arange(nC, device=dev)
    cover = bbox = k2 = chunks = 0
    for b in range(B):
        ov = (FU._chunk_hits_tile(cbb[b], bounds) & (c >= tr[b, :, :1])
              & (c < tr[b, :, 1:]))                        # (T, nC)
        t_i, c_i = torch.nonzero(ov, as_tuple=True)
        chunks += int(torch.unique(c_i).numel())
        for s in range(0, t_i.numel(), 4096):
            t, ci = t_i[s:s + 4096], c_i[s:s + 4096]
            f = vt[b, ci]                                  # (V, FC, NCOL)
            bb = f[..., FU._BB:FU._BB + 4]
            fx = f[..., FU._VX:FU._VX + 6:2]               # (V, FC, 3)
            fy = f[..., FU._VX + 1:FU._VX + 6:2]
            xs, ys = xcol[t][:, None], yrow[t][:, None]
            cols = ((xs >= bb[..., 0:1]) & (xs < bb[..., 2:3])).double()
            rows = ((ys >= bb[..., 1:2]) & (ys < bb[..., 3:4])).double()
            bbox += int((cols.sum(-1) * rows.sum(-1)).sum())
            own_c = ((xs >= fx.amin(-1, keepdim=True))
                     & (xs <= fx.amax(-1, keepdim=True))
                     & (f[..., FU._VALID:FU._VALID + 1] > 0.))
            own_r = ((ys >= fy.amin(-1, keepdim=True))
                     & (ys <= fy.amax(-1, keepdim=True)))
            cover += int((own_c.sum(-1) * own_r.sum(-1)).sum())
            k2 += int(torch.einsum('vfc,vrc,vfr->', cols,
                                   gz[b, t].double(), rows))
    table = chunks * FU.FC * FU._NCOL * 4
    k1_bytes = table + B * T * 8 + B * nC * 16 + B * H * H * 8
    k1_flops = K1_COVER_FLOPS * cover + K1_MASK_FLOPS * bbox
    k2_bytes = (table + B * nC * 24 + B * H * H * 4
                + B * nC * FU.FC * 6 * 4)
    return k1_bytes, k1_flops, k2_bytes, K2_FLOPS * k2


def _probe_path(run, *args, **kwargs):
    """Drive one probe entry point with every probe kernel's launch count
    set to 0 just before; returns (its result, the counts just after)."""
    for k in PK.LAUNCHES:
        PK.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    res = run(*args, **kwargs)
    torch.cuda.synchronize()
    return res, dict(PK.LAUNCHES)


def _probe_counts():
    return sum(PK.LAUNCHES.values())


def _p1_line(t):
    """A P1 kernel's two times beside its library call's and its bound."""
    lib = ('none' if t['library_ms'] is None else
           f'{t["library_ms"]:.4f} / {t["library_device_ms"]:.4f}')
    return (f'{t["ms"]:.4f} ms per call / {t["device_ms"]:.4f} ms on the '
            f'device; library {lib}; plain {t["plain_ms"]:.4f}; bound '
            f'{t["bound_ms"]:.4f} ({t["bound_by"]})')


def probe_p1(spc, card):
    """Phase 11: P1 through ``probes.mosaic3.run``: every kernel against
    its plain version (the script's ones, random x, K3's staging shape,
    kA's large shape), captured against eager launches; times per call and
    on the device beside the library call's, at each shape."""
    rows = spc['table'].rows.shape[0]
    t0 = time.perf_counter()
    res, counts = _probe_path(mosaic3.run, spc['o'].device, table_rows=rows)
    print(f'P1 kA..kH vs plain (script inputs, random x, kB/kC/kD at '
          f'K3\'s staging shape {mosaic3.STAGING} with {rows} table rows, '
          f'{"/".join(mosaic3.LARGE)} at {mosaic3.LARGE_NB} x {mosaic3.R} x '
          f'{mosaic3.C}): bitwise equal, max|d| '
          f'{max(res["max_abs_err"].values()):.1e}; every kernel\'s launch '
          f'captured in a CUDA graph equals its eager launch (kB/kC/kD also '
          f'at the staging shape); launches {counts}; '
          f'{time.perf_counter() - t0:.1f} s')
    print(f'[{card}] P1 times: per call (time_ms: events around '
          f'{mosaic3.ITERS} back-to-back Python calls) / on the device '
          f'(device_ms: one CUDA graph of the same calls, host cost out); '
          f'library call the same two ways, in turns with the kernel')
    for where in ('script', 'staging', 'large'):
        for name, t in res[where].items():
            print(f'[{card}] P1 {name} ({where}): {_p1_line(t)}')
    host = ', '.join(f'{k} {v:.3f}' for k, v in res['host_us'].items())
    print(f'[{card}] P1 host us per call (perf_counter, '
          f'{mosaic3.HOST_CALLS} calls, script shape): {host}')
    sa, sd = res['script']['kA'], res['script']['kD']
    la, gd = res['large']['kA'], res['staging']['kD']
    print(f'[{card}] P1 targets: kA per call {sa["ms"]:.4f} <= torch.mul '
          f'{sa["library_ms"]:.4f}: {sa["ms"] <= sa["library_ms"]}; kA on '
          f'the device {sa["device_ms"]:.4f} <= {sa["library_device_ms"]:.4f}'
          f': {sa["device_ms"] <= sa["library_device_ms"]}; kD per call '
          f'{sd["ms"]:.4f} <= F.embedding_bag {sd["library_ms"]:.4f}: '
          f'{sd["ms"] <= sd["library_ms"]}; kD on the device '
          f'{sd["device_ms"]:.4f} <= {sd["library_device_ms"]:.4f}: '
          f'{sd["device_ms"] <= sd["library_device_ms"]}; kD at the staging '
          f'shape {gd["ms"]:.4f} <= 0.11 and < {gd["library_ms"]:.4f}: '
          f'{gd["ms"] <= 0.11 and gd["ms"] < gd["library_ms"]}; kA at the '
          f'large shape {la["device_ms"]:.4f} ms = '
          f'{la["bound_ms"] / la["device_ms"]:.1%} of its bound (>= 50 %: '
          f'{la["bound_ms"] / la["device_ms"] >= 0.5})')
    for where, row in (('script', mosaic3.R * mosaic3.C),
                       ('staging', mosaic3.STAGING['rows'][0]
                        * mosaic3.STAGING['rows'][1])):
        sb, sc = res[where]['kB'], res[where]['kC']
        print(f'[{card}] P1 {where}: kB (TMA ring of {PK.KB_SLOTS} row slots, '
              f'{PK.kb_smem_bytes(row)} B of shared memory a CTA) '
              f'{sb["ms"]:.4f} / {sb["device_ms"]:.4f} ms against kC (rows '
              f'into registers, kD\'s kernel) {sc["ms"]:.4f} / '
              f'{sc["device_ms"]:.4f} ms (per call / device; kC / kB on the '
              f'device {sc["device_ms"] / sb["device_ms"]:.3f}); '
              f'F.embedding_bag {sb["library_ms"]:.4f} / '
              f'{sb["library_device_ms"]:.4f}; bound {sb["bound_ms"]:.4f} '
              f'ms: kB {sb["bound_ms"] / sb["device_ms"]:.1%}, kC '
              f'{sc["bound_ms"] / sc["device_ms"]:.1%}')
    shares = {name: res['large'][name]['bound_ms']
              / res['large'][name]['device_ms'] for name in mosaic3.SHIFTS}
    verdict = ('every one >= 50 %: left alone' if min(shares.values()) >= 0.5
               else 'under 50 %: shift_kernel is next')
    print(f'[{card}] P1 kE..kH at {mosaic3.LARGE_NB} x {mosaic3.R} x '
          f'{mosaic3.C}: share of the bound on the device '
          + ', '.join(f'{k} {v:.1%}' for k, v in shares.items())
          + f'; verdict: {verdict}')
    _check(all(counts[k] >= 1 for k in mosaic3.KERNELS),
           'every P1 kernel launched on its path')
    return res, counts


def probe_p2(spc, card):
    """Phase 12: P2 and the trace by stage through ``probes.stages.run``."""
    cell = {k: spc[k] for k in ('octree', 'ph', 'pyramid', 'exsum', 'table',
                                'o', 'd')}
    t0 = time.perf_counter()
    res, counts = _probe_path(stages.run, spc['o'].device, cell=cell,
                              offset_after=False)       # phase 10 has it
    print(f'P2 dummy kernel vs 2 x: bitwise equal, its captured launch equal '
          f'to its eager one; launches {counts["dummy"]}; '
          f'{time.perf_counter() - t0:.1f} s')
    for n, t in res['dummy'].items():
        print(f'[{card}] P2 dummy kernel (a CTA per {PK.P2_TILE_BYTES} B '
              f'tile, TMA in and out), {n} steps of 8 x 128 f32: '
              f'{t["ms"]:.4f} ms per '
              f'call / {t["device_ms"]:.4f} ms on the device '
              f'({t["device_ns_per_step"]:.3f} ns per step); torch.mul '
              f'{t["library_ms"]:.4f} / {t["library_device_ms"]:.4f} (in '
              f'turns, {stages.P2_ITERS} calls a turn); plain '
              f'{t["plain_ms"]:.4f}; bound {t["bound_ms"]:.4f} ms '
              f'({t["bound_by"]}): kernel {t["bound_ms"] / t["device_ms"]:.1%}'
              f', torch.mul {t["bound_ms"] / t["library_device_ms"]:.1%}; '
              f'device <= torch.mul: '
              f'{t["device_ms"] <= t["library_device_ms"]}; peak '
              f'{t["peak_gib"]:.2f} GiB')
    tr = res['trace']
    print(f'[{card}] trace by stage ({res["counts"]}): S1 candidates '
          f'{tr["s1"]:.3f} ms, S1b + order {tr["s1b"]:.3f} ms, S2 + gathers '
          f'{tr["s2"]:.3f} ms, S3 whole trace {tr["s3"]:.3f} ms; on their '
          f'own: K3 {tr["k3"]:.3f} ms, output allocation + fills '
          f'{tr["fills"]:.3f} ms')
    _check(counts['dummy'] >= 1, 'the P2 kernel launched on its path')
    _check(not res['counts']['saturated'], 'the staged trace does not '
           'saturate')
    return res, counts


def probe_p3(args, dense_args, card):
    """Phase 13: P3, K3 by stage, through ``probes.kbisect.run``."""
    t0 = time.perf_counter()
    res, counts = _probe_path(kbisect.run, args['rays'].device,
                              spc_args=args,
                              scenes={'dense level-6': dense_args})
    print(f'P3 stages 1-6 vs plain, with and without exit depths, bitwise '
          f'equal on {res["scenes"]}; at the SPC cell ({res["spc"]}) every '
          f'stage = plain and stage 6 = K3 bit for bit; launches {counts}; '
          f'{time.perf_counter() - t0:.1f} s')
    for st, t in res['stages'].items():
        print(f'[{card}] P3 stage {st}: {t["ms"]:.4f} ms (+{t["delta_ms"]:.4f}'
              f'), plain {t["plain_ms"]:.2f} ms')
    print(f'[{card}] P3 K3 in the same loop {res["k3_ms"]:.4f} ms; bound '
          f'{res["bound_ms"]:.4f} ms ({res["bound_by"]}: {res["flops"]:.4g} '
          f'flops, {res["bytes"]:.4g} bytes)')
    _check(res['scenes']['hits']['rays_over_kbuf'] > 0
           and res['scenes']['dense level-6']['rays_over_64'] > 0,
           'P3 scenes with counts past 64 and past kbuf')
    _check(all(counts[f'stage{st}'] >= 1 for st in PK.STAGES),
           'every P3 stage launched on its path')
    return res, counts


# ---------------------------------------------------------------------------
# The parts of a step, timed inside the step

def step_parts_ms(step, runs=3):
    """(parts, steps): ``parts`` (runs, k) ms of ``step(mark)`` after a
    warm-up step, from a CUDA event before the step and one at each of its
    k ``mark()`` calls, all on the current stream inside the same step;
    ``steps`` (runs,) ms from the first event to the last.  The parts are
    contiguous, so they add up to the step: no part is derived by
    subtracting a time taken apart."""
    step(lambda: None)
    parts, steps = [], []
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True)]
        torch.cuda.synchronize()
        ev[0].record()

        def mark():
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()

        step(mark)
        torch.cuda.synchronize()
        parts.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
        steps.append(ev[0].elapsed_time(ev[-1]))
    return np.asarray(parts), np.asarray(steps)


def check_parts(what, names, parts, steps):
    """The parts of each timed step add up to it (within 1 % + 0.01 ms) and
    none is negative; returns the line of their means."""
    _check(parts.shape[1] == len(names) and bool((parts >= 0).all()),
           f'{what}: one non-negative time per part')
    _check(bool((np.abs(parts.sum(1) - steps)
                 <= PARTS_RTOL * steps + PARTS_ATOL_MS).all()),
           f'{what}: the parts add up to the step')
    return (', '.join(f'{n} {m:.3f}' for n, m in zip(names, parts.mean(0)))
            + f' ms, sum {parts.sum(1).mean():.3f} = step '
            f'{steps.mean():.3f} ms (CUDA events inside the same '
            f'{len(steps)} steps)')


# ---------------------------------------------------------------------------
# BASELINE config #1: OBJ import -> k-buffer ('jnp') DIB-R at 256^2

def _z_ties(scene, fid_a, fid_b, eps=Z_TIE_REL):
    """For the pixels where the two selections differ: whether both faces
    cover the pixel (normalized barycentrics >= -eps, in float64) and their
    interpolated z agree within eps relative (a z tie on a shared edge)."""
    H = scene['height']
    with torch.no_grad():
        fvc, fvi, _ = M._prepare(scene['params'], scene['views'],
                                 scene['faces'])
    b, i, j = torch.nonzero(fid_a != fid_b, as_tuple=True)
    if b.numel() == 0:
        return 0, True
    xs = (MULT / H) * (2 * j.double() + 1 - H)
    ys = (MULT / H) * (H - 2 * i.double() - 1)
    zs = []
    for fid in (fid_a, fid_b):
        f = fid[b, i, j].long()
        v = fvi[b, f].double() * MULT                       # (N, 3, 2)
        e = v - torch.stack([xs, ys], -1)[:, None]
        w = torch.stack([e[:, 1, 0] * e[:, 2, 1] - e[:, 1, 1] * e[:, 2, 0],
                         e[:, 2, 0] * e[:, 0, 1] - e[:, 2, 1] * e[:, 0, 0],
                         e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]],
                        -1)
        w = w / w.sum(-1, keepdim=True)
        covers = (f >= 0) & (w >= -eps).all(-1)
        zs.append((covers, (w * fvc[b, f, :, 2].double()).sum(-1)))
    (ca, za), (cb, zb) = zs
    tie = ca & cb & ((za - zb).abs() <= eps * torch.maximum(
        za.abs(), zb.abs()))
    return b.numel(), bool(tie.all())


def config1(dev, card):
    """Phase 14: BASELINE config #1 on the card: the sphere written as OBJ
    + MTL, imported, trained with backend='jnp' (the brute-force z-buffer
    and the k-buffer soft mask) at 256^2; its selection against K1's; step
    0 against the CPU; times."""
    s = uv_sphere(*SPHERE)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = import_mesh(write_sphere_obj(tmp, s), with_materials=True,
                           device=dev)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) * 1e3
    fu = torch.as_tensor(s.uvs[s.face_uvs_idx])
    same = (mesh.vertices.device.type == torch.device(dev).type
            and torch.equal(mesh.vertices.cpu(), torch.as_tensor(s.vertices))
            and torch.equal(mesh.faces.cpu(), torch.as_tensor(s.faces))
            and torch.equal(mesh.face_uvs.cpu(), fu))
    print(f'import_mesh (OBJ + MTL text of uv_sphere{SPHERE}, '
          f'with_materials=True, on the card): {mesh.vertices.shape[0]} '
          f'vertices, {mesh.faces.shape[0]} faces, {len(mesh.materials)} '
          f'material; vertices, faces and face uvs equal to the '
          f"generator's: {same}; {import_ms:.1f} ms host clock")
    _check(same, 'imported mesh equals the generator')
    _check(len(mesh.materials) == 1
           and bool((mesh.material_assignments == 0).all()),
           'one material on every face')

    scene = make_scene(dev, mesh=mesh, **CFG1)
    H, B = scene['height'], CFG1['views']
    fid_j, kbuf = M.compute_selection(scene['params'], scene['views'],
                                      scene['faces'], H, H, backend='jnp',
                                      knum=CFG1['knum'])
    fid_f, _ = M.compute_selection(scene['params'], scene['views'],
                                   scene['faces'], H, H, backend='fused')
    n_diff, ties = _z_ties(scene, fid_j, fid_f)
    share = n_diff / fid_j.numel()
    print(f"'jnp' face_idx vs K1's at {H}^2, {B} views: {n_diff} of "
          f'{fid_j.numel()} pixels differ (share {share:.2e}, limit '
          f'{JNP_FID_MISMATCH_MAX:g}), all at z ties (both faces cover the '
          f'pixel, z within {Z_TIE_REL:g} relative): {ties}; k-buffer '
          f'slots filled {(kbuf >= 0).float().mean().item():.4f}')
    _check(share <= JNP_FID_MISMATCH_MAX and ties,
           "'jnp' selection equals K1's but at z ties")

    launches, losses, call, _, _ = train(scene)
    del call
    _check(launches['fwd'] == launches['bwd'] == 0,
           "the 'jnp' path runs neither K1 nor K2")
    cpu_s = check_step_against_plain(make_scene(
        dev, mesh=mesh, **dict(CFG1, **STEP0_SIZE)))

    params = scene['params']
    step_ms = time_ms(lambda: _step(scene, params), 3)
    with torch.no_grad():
        fvc, fvi, fn = M._prepare(params, scene['views'], scene['faces'])
    valid = fn[..., 2] >= 0.
    zsel_ms = time_ms(lambda: rasterize_selection(
        H, H, fvc[..., 2], fvi, valid, backend='jnp'), 3)
    face_idx = rasterize_selection(H, H, fvc[..., 2], fvi, valid,
                                   backend='jnp')
    ksel_ms = time_ms(lambda: dibr_soft_mask_select(
        fvi, face_idx, knum=CFG1['knum']), 3)
    kb = dibr_soft_mask_select(fvi, face_idx, knum=CFG1['knum'])
    g = torch.as_tensor(np.random.default_rng(2).standard_normal(
        tuple(face_idx.shape)).astype(np.float32), device=dev)

    def epilogue(mark):
        f = fvi.detach().requires_grad_()
        m = dibr_soft_mask(f, face_idx, knum=CFG1['knum'], kbuf=kb)
        mark()
        m.backward(g)
        mark()

    split = check_parts('config #1 soft-mask epilogue',
                        ('forward', 'backward'),
                        *step_parts_ms(epilogue, 5))
    print(f'[{card}] config #1 step (\'jnp\': selection + render_loss + '
          f'backward, {B} views, {H}x{H}, {scene["faces"].shape[0]} faces, '
          f'knum {CFG1["knum"]}): {step_ms:.3f} ms = '
          f'{B * H * H / step_ms / 1e3:.3f} Mpix/s')
    print(f'[{card}] config #1 z-buffer selection (_selection_jnp) '
          f'{zsel_ms:.3f} ms; k-buffer selection (dibr_soft_mask_select) '
          f'{ksel_ms:.3f} ms; soft-mask epilogue: {split}')
    step_profile(lambda: _step(scene, scene['params']), card)
    return dict(step_ms=step_ms, cpu_s=cpu_s,
                launches={k: launches[k] for k in EPILOGUE + SHADE})


# ---------------------------------------------------------------------------
# BASELINE config #4: DefTet sparse render at 256^2

def deftet_cell(dev, height):
    """bench.py::_phase_deftet's inputs: one view of the sphere through the
    trainer's _prepare; pixel coords on a linspace grid; range (-1e4, 0);
    face normals as features (plus, for the gradient checks, the corners'
    camera-space positions, which vary over a face)."""
    s = uv_sphere(*SPHERE)
    params = M.init_params(s, texture_res=16, device=dev)
    views = M.make_views(1, device=dev)
    with torch.no_grad():
        fvc, fvi, fn = M._prepare(params, views,
                                  torch.as_tensor(s.faces, device=dev))
    lin = torch.linspace(-1., 1., height, device=dev)
    ys, xs = torch.meshgrid(lin, lin, indexing='ij')
    P = height * height
    pc = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)[None]
    rr = torch.tensor([[-1e4, 0.]], device=dev).expand(P, 2)[None]
    normals = fn[:, :, None, :].expand(tuple(fn.shape[:2]) + (3, 3))
    return dict(pc=pc, rr=rr, fvz=fvc[..., 2].contiguous(), fvi=fvi,
                normals=normals.contiguous(), corners=fvc.contiguous())


def _deftet_run(cell, engine, ct=None):
    """fwd + bwd on ``cell`` with features [normals, corners] and the
    cotangents ``ct`` (numpy-seeded when None); returns (feats, face_idx,
    grads w.r.t. fvi, fvz, normals, corners)."""
    leaves = [cell[k].detach().clone().requires_grad_()
              for k in ('fvi', 'fvz', 'normals', 'corners')]
    feats, idx = deftet_sparse_render(cell['pc'], cell['rr'], leaves[1],
                                      leaves[0], leaves[2:],
                                      knum=DEFTET['knum'], **engine)
    if ct is None:
        rng = np.random.default_rng(5)
        ct = [torch.as_tensor(rng.standard_normal(tuple(f.shape)).astype(
            np.float32), device=f.device) for f in feats]
    loss = sum((f * c).sum() for f, c in zip(feats, ct))
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    return [f.detach() for f in feats], idx, grads, ct


def _deftet_compare(a, b, what):
    """(feature max|d|, gradient max|d| / max|g|); raises past the limits."""
    _check(torch.equal(a[1].cpu(), b[1].cpu()), f'{what}: face_idx equal')
    ferr = max((x.cpu() - y.cpu()).abs().max().item()
               for x, y in zip(a[0], b[0]))
    _check(ferr <= DEFTET_FEAT_ATOL, f'{what}: features')
    gerr = 0.
    for x, y in zip(a[2], b[2]):
        x, y = x.cpu(), y.cpu()
        scale = y.abs().max().item()
        err = (x - y).abs().max().item()
        if scale < DEFTET_ZERO_GRAD:    # z only selects and orders
            _check(err < DEFTET_ZERO_GRAD, f'{what}: zero gradient')
            continue
        gerr = max(gerr, err / scale)
    _check(gerr <= DEFTET_GRAD_REL, f'{what}: gradients')
    return ferr, gerr


def deftet(dev, card):
    """Phase 15: the DefTet cell of bench.py::_phase_deftet, binned engine
    (max_candidates 2048, pixel_chunk 1024), against the default engine on
    the card and against the CPU at 64^2; times."""
    H = DEFTET['height']
    cell = deftet_cell(dev, H)
    binned = dict(max_candidates=DEFTET['max_candidates'],
                  pixel_chunk=DEFTET['pixel_chunk'])
    b = _deftet_run(cell, binned)
    d = _deftet_run(cell, {}, b[3])
    ferr, gerr = _deftet_compare(b, d, 'binned vs default engine')
    hits = (b[1] >= 0).sum(-1)
    print(f'DefTet {H}^2, knum {DEFTET["knum"]}: binned engine vs default '
          f'engine on the card: sorted face_idx equal, features max|d| '
          f'{ferr:.2e} (limit {DEFTET_FEAT_ATOL:g}), gradients max|d|/max|g|'
          f' {gerr:.2e} (limit {DEFTET_GRAD_REL:g}); layers per pixel max '
          f'{int(hits.max())}, pixels hit {(hits > 0).float().mean():.4f}')
    _check(int(hits.max()) >= 2, 'pixels with several layers')

    small = deftet_cell(dev, DEFTET['check_height'])
    card_s = _deftet_run(small, binned)
    cpu = {k: v.cpu() for k, v in small.items()}
    t0 = time.perf_counter()
    cpu_s = _deftet_run(cpu, binned, [c.cpu() for c in card_s[3]])
    cpu_sec = time.perf_counter() - t0
    ferr_c, gerr_c = _deftet_compare(card_s, cpu_s, 'card vs CPU')
    print(f'DefTet step 0 at {DEFTET["check_height"]}^2, card vs CPU '
          f'({cpu_sec:.2f} s on the CPU): face_idx equal, features max|d| '
          f'{ferr_c:.2e}, gradients max|d|/max|g| {gerr_c:.2e}')

    def step(**engine):
        f = cell['fvi'].detach().requires_grad_()
        out, fidx = deftet_sparse_render(cell['pc'], cell['rr'],
                                         cell['fvz'], f, cell['normals'],
                                         knum=DEFTET['knum'], **engine)
        loss = torch.where((fidx >= 0)[..., None], out, 0.).sum()
        loss.backward()

    step_ms = time_ms(lambda: step(**binned), 5)
    default_ms = time_ms(lambda: step(), 3)
    P = H * H
    print(f'[{card}] DefTet step (binned engine, fwd + bwd to the '
          f'image-space vertices, {P} pixels, knum {DEFTET["knum"]}, '
          f'{cell["fvi"].shape[1]} faces): {step_ms:.3f} ms = '
          f'{P / step_ms / 1e3:.3f} Mpix/s; default engine {default_ms:.3f} '
          f'ms = {P / default_ms / 1e3:.3f} Mpix/s')
    return dict(step_ms=step_ms, cpu_s=cpu_sec)


# ---------------------------------------------------------------------------
# tetmesh ops and losses

def _close_grads(a, b, what):
    scale = b.abs().max().item()
    err = (a.cpu() - b).abs().max().item()
    _check(scale > 0 and err <= TET_GRAD_REL * scale, what)
    return err / scale


def tetmesh(dev, card):
    """Phase 16: marching tetrahedra on a tet grid of a cube with a sphere's
    SDF, subdivide_tetmesh, equivolume and amips with gradients; each on
    the card against the CPU."""
    v, tets = tet_grid(TET_GRID)
    sdf = (np.linalg.norm(v, axis=-1) - SDF_RADIUS)[None].astype(np.float32)
    res = {}
    for where in (dev, 'cpu'):
        vt = torch.tensor(v[None], device=where, requires_grad=True)
        st = torch.tensor(sdf, device=where, requires_grad=True)
        verts, faces, tet_idx = marching_tetrahedra(vt, tets, st,
                                                    return_tet_idx=True)
        ct = torch.as_tensor(np.random.default_rng(9).standard_normal(
            tuple(verts[0].shape)).astype(np.float32), device=where)
        gv, gs = torch.autograd.grad((verts[0] * ct).sum(), [vt, st])
        res[str(where)] = dict(verts=verts[0].detach().cpu(),
                               faces=faces[0].cpu(), tet_idx=tet_idx[0].cpu(),
                               gv=gv.cpu(), gs=gs.cpu())
    c, g = res['cpu'], res[str(dev)]
    verr = (g['verts'] - c['verts']).abs().max().item()
    _check(torch.equal(g['faces'], c['faces'])
           and torch.equal(g['tet_idx'], c['tet_idx']),
           'marching tetrahedra: faces and tet ids equal')
    _check(verr <= MT_VERT_ATOL, 'marching tetrahedra: vertices')
    mt_g = max(_close_grads(g['gs'], c['gs'], 'marching tetrahedra: d/dsdf'),
               _close_grads(g['gv'], c['gv'], 'marching tetrahedra: d/dv'))
    print(f'marching_tetrahedra on a {TET_GRID}^3 grid ({len(tets)} tets, '
          f'{len(v)} vertices), sphere SDF r={SDF_RADIUS}: '
          f'{c["faces"].shape[0]} faces, {c["verts"].shape[0]} vertices; '
          f'card vs CPU: faces and tet ids equal, vertices max|d| '
          f'{verr:.2e} (limit {MT_VERT_ATOL:g}), gradients to sdf and '
          f'vertices max|d|/max|g| {mt_g:.2e}')

    jitter = (0.2 / TET_GRID * np.random.default_rng(8).standard_normal(
        (1,) + v.shape)).astype(np.float32)
    out = {}
    for where in (dev, 'cpu'):
        rest, new_tets = subdivide_tetmesh(torch.as_tensor(v[None]), tets,
                                           device=where)
        moved, _ = subdivide_tetmesh(torch.as_tensor(v[None] + jitter),
                                     tets, device=where)
        tv = moved[:, new_tets].detach().requires_grad_()
        inv = inverse_vertices_offset(rest[:, new_tets])
        ev = met_tet.equivolume(tv)
        am = met_tet.amips(tv, inv)
        g_ev, = torch.autograd.grad(ev.sum(), [tv])
        g_am, = torch.autograd.grad(am.sum(), [tv])
        out[str(where)] = dict(tets=new_tets.cpu(), rest=rest.cpu(),
                               ev=ev.item(), am=am.item(), g_ev=g_ev.cpu(),
                               g_am=g_am.cpu())
    c, g = out['cpu'], out[str(dev)]
    _check(torch.equal(g['tets'], c['tets']), 'subdivide: tets equal')
    serr = (g['rest'] - c['rest']).abs().max().item()
    _check(serr <= MT_VERT_ATOL, 'subdivide: vertices')
    rel = [abs(g[k] - c[k]) / abs(c[k]) for k in ('ev', 'am')]
    _check(max(rel) <= TET_LOSS_RTOL, 'equivolume and amips card vs CPU')
    lg = max(_close_grads(g['g_ev'], c['g_ev'], 'equivolume gradient'),
             _close_grads(g['g_am'], c['g_am'], 'amips gradient'))
    print(f'subdivide_tetmesh once: {c["tets"].shape[0]} tets, card vs CPU '
          f'equal (vertices max|d| {serr:.1e}); equivolume {c["ev"]:.6e}, '
          f'amips {c["am"]:.6f}, card vs CPU rel {rel[0]:.1e}, {rel[1]:.1e}'
          f' (limit {TET_LOSS_RTOL:g}); gradients max|d|/max|g| {lg:.2e}')

    vt = torch.tensor(v[None], device=dev)
    st = torch.tensor(sdf, device=dev)
    mt_ms = time_ms(lambda: marching_tetrahedra(vt, tets, st), 3)
    sub_ms = time_ms(lambda: subdivide_tetmesh(vt, tets), 3)
    rest, new_tets = subdivide_tetmesh(vt, tets)
    inv = inverse_vertices_offset(rest[:, new_tets])
    moved, _ = subdivide_tetmesh(torch.as_tensor(v[None] + jitter,
                                                 device=dev), tets)

    def losses():
        tv = moved[:, new_tets].requires_grad_()
        loss = met_tet.equivolume(tv).sum() + met_tet.amips(tv, inv).sum()
        loss.backward()

    loss_ms = time_ms(losses, 5)
    print(f'[{card}] marching_tetrahedra {mt_ms:.3f} ms (host topology); '
          f'subdivide_tetmesh {sub_ms:.3f} ms; equivolume + amips fwd + bwd '
          f'over {new_tets.shape[0]} tets {loss_ms:.3f} ms')


# ---------------------------------------------------------------------------
# Path A: a pinhole camera's rays through K3, trilinear features on the
# level-10 dual corners, Beer-Lambert integration, L1, Adam (NGLOD-style)

def corner_features(n, seed):
    """(n, FEAT_DIM) float32 corner features from a numpy seed: colour in
    [0, 1), optical thickness in [0.5, 1.5), the rest N(0, 1)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.random((n, 3)), rng.uniform(0.5, 1.5, (n, 1)),
                           rng.normal(size=(n, FEAT_DIM - 4))],
                          -1).astype(np.float32)


def nglod_scene(fv, dev):
    """Path A's scene through the entry points: the level-10 octree, its
    dual and trinkets, the cell table; the trained and the target corner
    features (numpy) of the level-10 dual slice."""
    octree, _, _, _ = unbatched_mesh_to_spc_device(
        torch.as_tensor(fv, device=dev), SPC_LEVEL, cap=SPC_CAPS[0])
    _, pyramids, exsum = scan_octrees(octree, [octree.shape[0]])
    ph = generate_points(octree, pyramids, exsum)
    pyr = pyramids[0]
    dual, pyr_dual = unbatched_make_dual(ph, pyr)
    trinkets, _ = unbatched_make_trinkets(ph, pyr, dual, pyr_dual)
    n = int(pyr_dual[0, SPC_LEVEL])
    return dict(octree=octree, pyramid=pyr, exsum=exsum, ph=ph,
                trinkets=trinkets, n_dual=n,
                table=build_cell_table(ph, pyr, SPC_LEVEL, **CELLS),
                feats=corner_features(n, FEAT_SEEDS[0]),
                target_feats=corner_features(n, FEAT_SEEDS[1]))


def camera_trace(scene, camera, trace=NG_TRACE):
    """The camera's rays (image order) and their k-buffer of hits, traced
    with the ``trace`` settings."""
    o, d = (x[0] for x in camera.generate_rays())
    hits = unbatched_raytrace_coherent(
        scene['octree'], scene['ph'], scene['pyramid'], scene['exsum'], o, d,
        SPC_LEVEL, engine='mosaic', cell_table=scene['table'],
        grid_shape=(camera.height, camera.width), **trace)
    return o, d, hits


def interpolate(scene, o, d, nuggets, feats):
    """The features at each nugget's mid depth, o + d (t_near + t_far) / 2
    (one sample per nugget)."""
    ridx, pidx, depths = nuggets
    mid = o[ridx] + d[ridx] * ((depths[:, 0] + depths[:, 1]) / 2)[:, None]
    return unbatched_interpolate_trilinear(
        mid[:, None], pidx, scene['ph'], scene['trinkets'], feats,
        SPC_LEVEL)[:, 0]


def integrate(samples, ridx, num_rays):
    """Channels 0-2 as colour and 3 as optical thickness, integrated along
    each ray into a (num_rays, 3) image (0 where a ray hits nothing)."""
    first = mark_pack_boundaries(ridx)
    colour, _ = exponential_integration(samples[:, :3], samples[:, 3:4],
                                        first)
    return torch.zeros((num_rays, 3), device=samples.device).index_put(
        (ridx[first].long(),), colour)


def feature_image(scene, camera, feats, trace=NG_TRACE):
    o, d, hits = camera_trace(scene, camera, trace)
    nuggets = hits_to_nuggets(hits)
    samples = interpolate(scene, o, d, nuggets, feats)
    return integrate(samples, nuggets[0], o.shape[0]), hits


def nglod_step(scene, camera, feats, target, trace=NG_TRACE,
               mark=lambda: None):
    """Render, L1 against ``target``, backward to ``feats``; ``mark()``
    after the forward and after the backward."""
    image, hits = feature_image(scene, camera, feats, trace)
    loss = (image - target).abs().mean()
    mark()
    feats.grad = None
    loss.backward()
    mark()
    return loss, hits


def super_tile_candidates(table, o, d, rt):
    """The cells each super-tile's interval beam meets (the culling's first
    test, before any cap), for rays in trace order."""
    o, d = _pad_rays(o, d, rt)
    nB = o.shape[0] // rt
    _, (olo, ohi, dlo, dhi) = _beam_bounds(o.reshape(nB, rt, 3),
                                           d.reshape(nB, rt, 3), nB // 64)
    Mc = table.blo.shape[0] - 1
    return _beam_chunk_test(olo[:, None], ohi[:, None], dlo[:, None],
                            dhi[:, None], table.blo[None, :Mc],
                            table.bhi[None, :Mc]).sum(1)


def make_camera(size, dev):
    return Camera.from_args(**CAMERA, width=size, height=size, device=dev)


def nglod_step0(scene, dev):
    """Step 0 at NG_STEP0^2 on the card and on the CPU (the scene copied,
    its cell table built there; K3's plain version traces): hits equal,
    loss and feature gradient close."""
    cpu = {k: scene[k].cpu() for k in ('octree', 'exsum', 'ph', 'trinkets')}
    cpu.update(pyramid=scene['pyramid'],
               table=build_cell_table(cpu['ph'], scene['pyramid'], SPC_LEVEL,
                                      **CELLS))
    out = {}
    for where, sc in ((dev, scene), ('cpu', cpu)):
        camera = make_camera(NG_STEP0, where)
        with torch.no_grad():
            target, hits = feature_image(sc, camera, torch.as_tensor(
                scene['target_feats'], device=where), NG_STEP0_TRACE)
        _check(not bool(hits.saturated), 'path A step 0 does not saturate')
        feats = torch.tensor(scene['feats'], device=where,
                             requires_grad=True)
        t0 = time.perf_counter()
        loss, hits = nglod_step(sc, camera, feats, target, NG_STEP0_TRACE)
        out[str(where)] = (loss.item(), feats.grad.cpu(), hits.count.cpu(),
                           hits.pidx.cpu(), time.perf_counter() - t0)
    (lg, gg, cg, pg, _), (lc, gc, cc, pc, cpu_s) = out[str(dev)], out['cpu']
    rel = abs(lg - lc) / abs(lc)
    scale = gc.abs().max().item()
    g_rel = (gg - gc).abs().max().item() / scale
    print(f'path A step 0 at {NG_STEP0}^2, card vs CPU ({cpu_s:.2f} s on the '
          f'CPU): hits equal {torch.equal(cg, cc) and torch.equal(pg, pc)}; '
          f'loss {lg:.7f} vs {lc:.7f} (rel {rel:.2e}, limit '
          f'{NG_LOSS_RTOL:g}); feature gradient max|d|/max|g| {g_rel:.2e} '
          f'(limit {NG_GRAD_REL:g})')
    _check(torch.equal(cg, cc) and torch.equal(pg, pc),
           'path A step 0: hits card == CPU')
    _check(rel <= NG_LOSS_RTOL, 'path A step 0: loss card vs CPU')
    _check(scale > 0 and g_rel <= NG_GRAD_REL,
           'path A step 0: feature gradient card vs CPU')


def path_a(fv, dev, card):
    """Phase 17: path A through the entry points at 1024^2 (5 Adam steps,
    K3's launches counted around them); K3 against its plain version on the
    camera's own rays; the trace against the BFS; step 0 against the CPU;
    times."""
    scene = nglod_scene(fv, dev)
    camera = make_camera(IMAGE, dev)
    N = IMAGE * IMAGE
    with torch.no_grad():
        target, hits = feature_image(scene, camera, torch.as_tensor(
            scene['target_feats'], device=dev))
    share = (hits.count > 0).float().mean().item()
    print(f'path A scene: level {SPC_LEVEL}, {scene["ph"].shape[0]} points, '
          f'{scene["n_dual"]} level-{SPC_LEVEL} dual corners x {FEAT_DIM} '
          f'features, {scene["table"].rows.shape[0] - 1} cells (overflow '
          f'{scene["table"].overflow}); pinhole camera {IMAGE}x{IMAGE}, eye '
          f'{CAMERA["eye"]}: {share:.4f} of the {N} pixels hit, '
          f'{int(hits.count.sum())} hits, max {int(hits.count.max())} per '
          f'ray, saturated {bool(hits.saturated)}')
    _check(0.3 <= share <= 0.6, 'path A: 30-60 % of the pixels hit')
    _check(scene['table'].overflow == 0, 'path A: cell table overflow 0')
    _check(not bool(hits.saturated), 'path A: the trace does not saturate')

    feats = torch.tensor(scene['feats'], device=dev, requires_grad=True)
    opt = torch.optim.Adam([feats], lr=FEAT_LR)
    losses = []
    torch.cuda.synchronize()
    zero_launches(('trace', 'cull'))
    with kept_launches(('cull',)) as kept:
        for _ in range(STEPS):
            loss, hits = nglod_step(scene, camera, feats, target)
            opt.step()
            losses.append(loss.item())
        torch.cuda.synchronize()
    launches, cull = read_launches(('trace', 'cull')).values()
    held, cull_err = hold_against_plain(kept, 'path A')
    print(f'path A, {STEPS} Adam steps (lr {FEAT_LR:g}): L1 '
          + ', '.join(f'{x:.7f}' for x in losses)
          + f'; K3 launches {launches}; C1 launches {cull}, held against '
          f'plain bit for bit {held["cull"]} (rays_per_tile '
          f'{kept["cull"][0][0][2].shape[1]}, ck_max {kept["cull"][0][0][5]})')
    _check(launches >= STEPS, 'K3 launched on every path A step')
    _check(cull == held['cull'] == STEPS,
           'C1 launched on every path A step, and held against plain')
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           'path A: the loss falls')

    o, d = (x[0] for x in camera.generate_rays())
    perm = torch.as_tensor(grid_order(IMAGE, IMAGE,
                                      TRACE['rays_per_tile'])[0], device=dev)
    keys = ('rays_per_tile', 'segments', 'max_super_voxels',
            'max_active_blocks')
    args, sat = trace_inputs(scene['table'], o[perm], d[perm],
                             knum=NG_TRACE['knum'],
                             **{k: NG_TRACE[k] for k in keys})
    off = scene['table'].offset
    out_k = _trace._trace_cuda(with_exit=True, pidx_offset=off, **args)
    torch.cuda.synchronize()
    out_p = _trace._trace_torch(with_exit=True, pidx_offset=off, **args)
    same = _same_outputs(out_k, out_p)
    err = _max_t_err(out_k, out_p)
    main = hits.count[perm]
    active = args['nb'][args['nb'] > 0]
    print(f'K3 vs plain on path A\'s pinhole rays: {active.shape[0]} '
          f'active blocks ({args["nb"].shape[0]} traced) of '
          f'{args["num_blocks"]}, candidate cells per active block max '
          f'{int(active.max())}, mean {active.float().mean().item():.2f}; '
          f'count, pidx, t_near and t_far (bitwise) equal: {same}; max|dt| '
          f'{err:.3e}; counts as on the main path: '
          f'{torch.equal(out_k[3].reshape(-1)[:N], main)}; '
          f'culling saturated {bool(sat)}')
    sup = super_tile_candidates(scene['table'], o[perm], d[perm],
                                TRACE['rays_per_tile'])
    print(f'  culling: candidate cells per super-tile (64 blocks) max '
          f'{int(sup.max())}, mean {sup.float().mean().item():.1f} of '
          f'{scene["table"].rows.shape[0] - 1} cells')
    _check(same, 'K3 equals its plain version on pinhole rays')
    _check(torch.equal(out_k[3].reshape(-1)[:N], main),
           'the path A steps went through the same K3 rows')
    _check(not bool(sat), 'path A culling does not saturate')
    hits_vs_bfs(scene, o, d, hits)
    nglod_step0(scene, dev)

    nuggets = hits_to_nuggets(hits)
    samples = interpolate(scene, o, d, nuggets, feats)
    step_ms = time_ms(lambda: nglod_step(scene, camera, feats, target), 3)
    trace_ms = time_ms(lambda: camera_trace(scene, camera), 3)
    nug_ms = time_ms(lambda: hits_to_nuggets(hits), 3)
    interp_ms = time_ms(lambda: interpolate(scene, o, d, nuggets, feats), 3)
    integ_ms = time_ms(lambda: integrate(samples, nuggets[0], N), 3)

    def adam_step(mark):
        nglod_step(scene, camera, feats, target, mark=mark)
        opt.step()
        mark()

    split = check_parts('path A step', ('forward', 'backward', 'Adam'),
                        *step_parts_ms(adam_step))
    launch = {k: v for k, v in args.items() if k != 'num_blocks'}
    k3 = {}
    for with_exit in (False, True):
        buf = _trace._outputs(args['num_blocks'], args['rays'].shape[1],
                              args['kbuf'], dev)
        k3[with_exit] = time_ms(lambda: _trace._launch(
            with_exit=with_exit, out=buf, pidx_offset=off, **launch), 20)
    k3_b, k3_f, _ = kbisect.trace_work(args, out_k[3], True)
    torch.cuda.reset_peak_memory_stats()
    nglod_step(scene, camera, feats, target)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[{card}] path A step (camera rays -> trace -> nuggets -> '
          f'trilinear -> integration -> L1 -> backward, {N} rays, '
          f'{nuggets[0].shape[0]} samples): {step_ms:.3f} ms = '
          f'{N / step_ms / 1e3:.3f} Mrays/s; with the Adam update, by '
          f'part: {split}; on their own: trace (rays + culling + K3 '
          f'+ outputs) {trace_ms:.3f} ms, hits_to_nuggets {nug_ms:.3f}, '
          f'interpolation {interp_ms:.3f}, integration + image '
          f'{integ_ms:.3f} ms; peak device memory of a step {peak:.3f} GiB')
    print(f'[{card}] K3 on the pinhole rays: {k3[False]:.4f} ms without '
          f'exit depths (phase 10\'s parallel rays: see above), '
          f'{k3[True]:.4f} ms with them (as path A runs it); bound '
          f'{_bound(k3_b, k3_f)["bound_ms"]:.4f} ms with exit depths '
          f'({k3_b} bytes, {k3_f} flops)')
    idle = step_profile(lambda: nglod_step(scene, camera, feats, target),
                        card)
    return dict(launches=launches, k3_ms=k3[False], k3_exit_ms=k3[True],
                k3_err=err, step_ms=step_ms, idle=idle, cull_launches=cull,
                cull_err=cull_err['cull'])


# ---------------------------------------------------------------------------
# Path B: sparse convolutions over the level-10 octree

def offsets(lo, hi):
    """All kernel vectors in [lo, hi)^3, x slowest: (K, 3) int32."""
    r = np.arange(lo, hi)
    return np.stack(np.meshgrid(r, r, r, indexing='ij'),
                    -1).reshape(-1, 3).astype(np.int32)


def conv_layers(dev):
    """Conv3d(16 -> 32, 3^3, jump 0) -> Conv3d(32 -> 64, 2^3, jump 1) ->
    ConvTranspose3d(64 -> 32, 2^3, jump 1), weights from CONV_SEED."""
    g = torch.Generator().manual_seed(CONV_SEED)
    return [Conv3d(16, 32, offsets(-1, 2), 0, generator=g, device=dev),
            Conv3d(32, 64, offsets(0, 2), 1, generator=g, device=dev),
            ConvTranspose3d(64, 32, offsets(0, 2), 1, generator=g,
                            device=dev)]


def conv_forward(spc, layers, x, level):
    """The stack's output, each layer's (input, input level) and the
    output level."""
    ins = []
    for layer in layers:
        ins.append((x, level))
        x, level = layer(spc.octrees, spc.point_hierarchies, level,
                         spc.pyramids, spc.exsum, x)
    return x, ins, level


def conv_step(spc, layers, x, level, mark=lambda: None):
    """Forward, L2 loss, backward to the input and the weights; ``mark()``
    after the forward and after the backward."""
    for p in [x] + [p for m in layers for p in m.parameters()]:
        p.grad = None
    out, _, _ = conv_forward(spc, layers, x, level)
    loss = out.square().mean()
    mark()
    loss.backward()
    mark()
    return out, loss


def conv_card_vs_cpu(fv, dev):
    """The stack at CONV_PARITY_LEVEL of the same mesh, on the card and on
    the CPU with the same weights and input: outputs and gradients."""
    octree = unbatched_mesh_to_spc_device(torch.as_tensor(fv, device=dev),
                                          CONV_PARITY_LEVEL)[0]
    res = {}
    for where in (dev, 'cpu'):
        spc = Spc(octree.to(where), [octree.shape[0]])
        layers = conv_layers(where)
        n = int(spc.pyramids[0, 0, CONV_PARITY_LEVEL])
        x = torch.tensor(np.random.default_rng(CONV_SEED).normal(
            size=(n, 16)).astype(np.float32), device=where,
            requires_grad=True)
        out, _ = conv_step(spc, layers, x, CONV_PARITY_LEVEL)
        res[str(where)] = [out.detach().cpu(), x.grad.cpu()] + [
            p.grad.cpu() for m in layers for p in m.parameters()]
    rel = [(g - c).abs().max().item() / c.abs().max().item()
           for g, c in zip(res[str(dev)], res['cpu'])]
    print(f'conv stack at level {CONV_PARITY_LEVEL} ({res["cpu"][0].shape[0]}'
          f' output points), card vs CPU: output max|d|/max {rel[0]:.2e} '
          f'(limit {CONV_OUT_REL:g}); gradients to the input, weights and '
          f'biases max|d|/max|g| {max(rel[1:]):.2e} (limit '
          f'{CONV_GRAD_REL:g})')
    _check(rel[0] <= CONV_OUT_REL, 'conv stack output card vs CPU')
    _check(max(rel[1:]) <= CONV_GRAD_REL, 'conv stack gradients card vs CPU')


def dense_card_vs_cpu(spc, fv, dev):
    """``to_dense`` at DENSE_LEVEL, ``Spc.from_features`` of that grid and
    ``trianglemeshes_to_voxelgrids`` at VOXEL_RES, card against CPU."""
    pyr = spc.pyramids
    n = int(pyr[0, 0, DENSE_LEVEL])
    x = np.random.default_rng(CONV_SEED + 1).normal(
        size=(n, 16)).astype(np.float32)
    s = uv_sphere(*SPHERE)
    verts = (s.vertices * SPC_RADIUS)[None].astype(np.float32)
    out = {}
    for where in (dev, 'cpu'):
        ph = spc.point_hierarchies.to(where)
        grid = to_dense(ph, pyr, torch.as_tensor(x, device=where),
                        DENSE_LEVEL)
        back = Spc.from_features(grid)
        vox = trianglemeshes_to_voxelgrids(torch.as_tensor(
            verts, device=where), s.faces, VOXEL_RES)
        out[str(where)] = [t.cpu() for t in (grid, back.octrees,
                                             back.features, vox)]
    g, c = out[str(dev)], out['cpu']
    same = [torch.equal(a, b) for a, b in zip(g, c)]
    prefix = int(pyr[0, 1, DENSE_LEVEL])
    round_trip = (torch.equal(c[1], spc.octrees[:prefix].cpu())
                  and torch.equal(c[2], torch.as_tensor(x)))
    print(f'to_dense at level {DENSE_LEVEL} ({n} points -> '
          f'{tuple(c[0].shape)}), Spc.from_features of it, '
          f'trianglemeshes_to_voxelgrids at {VOXEL_RES} ({int(c[3].sum())} '
          f'voxels): card == CPU {same}; from_features gives back the '
          f'octree\'s first {DENSE_LEVEL} levels and the features: '
          f'{round_trip}')
    _check(all(same), 'to_dense, from_features, voxelgrids card == CPU')
    _check(round_trip, 'from_features(to_dense(x)) == the octree and x')


def path_b(fv, dev, card):
    """Phase 18: the conv stack forward and backward over the level-10
    octree (an Spc); card against CPU at CONV_PARITY_LEVEL; to_dense,
    from_features and voxel grids card against CPU; times, peak memory."""
    octree = unbatched_mesh_to_spc_device(torch.as_tensor(fv, device=dev),
                                          SPC_LEVEL, cap=SPC_CAPS[0])[0]
    spc = Spc(octree, [octree.shape[0]])
    layers = conv_layers(dev)
    n = int(spc.pyramids[0, 0, SPC_LEVEL])
    x = torch.tensor(np.random.default_rng(CONV_SEED).normal(
        size=(n, 16)).astype(np.float32), device=dev, requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, loss = conv_step(spc, layers, x, SPC_LEVEL)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check(tuple(out.shape) == (n, 32) and bool(torch.isfinite(out).all()),
           'conv stack output shape, finite')
    _check(all(bool(torch.isfinite(p.grad).all()) and p.grad.abs().max() > 0
               for p in [x] + [p for m in layers for p in m.parameters()]),
           'conv stack gradients finite, non-zero')
    conv_card_vs_cpu(fv, dev)
    dense_card_vs_cpu(spc, fv, dev)

    step_ms = time_ms(lambda: conv_step(spc, layers, x, SPC_LEVEL), 3)
    split = check_parts('path B step', ('forward', 'backward'),
                        *step_parts_ms(lambda mark: conv_step(
                            spc, layers, x, SPC_LEVEL, mark)))
    _, ins, _ = conv_forward(spc, layers, x, SPC_LEVEL)
    pyr = spc.pyramids[0]
    parts = []
    for layer, (h, lv) in zip(layers, ins):
        transpose = isinstance(layer, ConvTranspose3d)
        out_lv = lv + layer.jump if transpose else lv - layer.jump
        pts = unbatched_get_level_points(spc.point_hierarchies, pyr, out_lv)
        kv = torch.as_tensor(layer.kernel_vectors, device=dev)
        coords, _ = tap_coords(pts, kv, layer.jump, transpose)
        pair_args = (spc.octrees, spc.exsum, pts, kv, layer.jump, lv,
                     int(pyr[1, lv]), transpose)
        pairs = tap_pairs(*pair_args)
        h = h.detach()
        parts.append(dict(
            query=time_ms(lambda: unbatched_query(spc.octrees, spc.exsum,
                                                  coords, lv), 3),
            pairs=time_ms(lambda: tap_pairs(*pair_args), 3),
            gather=time_ms(lambda: h[pairs[0]], 3),
            products=time_ms(lambda: tap_products(
                h, layer.weight.detach(), *pairs, pts.shape[0]), 3),
            n_pairs=pairs[0].shape[0], K=kv.shape[0], n_out=pts.shape[0]))
    print(f'[{card}] path B (Conv3d 16->32 3^3 -> Conv3d 32->64 2^3 jump 1 '
          f'-> ConvTranspose3d 64->32 2^3 jump 1 over {n} level-{SPC_LEVEL} '
          f'points, L2): forward + backward {step_ms:.3f} ms; by part: '
          f'{split}; peak device memory of a step {peak:.3f} GiB')
    for layer, p in zip(('conv 3^3', 'conv 2^3 down', 'transpose 2^3 up'),
                        parts):
        print(f'[{card}]   {layer}: {p["n_pairs"]} live (tap, output) pairs '
              f'of {p["K"] * p["n_out"]}; unbatched_query {p["query"]:.3f} '
              f'ms, query + compaction {p["pairs"]:.3f} ms, gather '
              f'{p["gather"]:.3f} ms, gather + per-tap matmul + index_add '
              f'{p["products"]:.3f} ms')
    idle = step_profile(lambda: conv_step(spc, layers, x, SPC_LEVEL), card)
    return dict(step_ms=step_ms, peak=peak, idle=idle)


# ---------------------------------------------------------------------------
# Path C: SG light recovery (DIB-R++): fixed geometry rasterized once per
# view through K1, SG diffuse + GGX specular over 32 lobes, masked MSE, Adam

def sg_cameras(size, views, dev):
    """``views`` pinhole cameras around the unit sphere, 70 degree fov."""
    az = np.arange(views) * (2. * np.pi / views) + 0.3
    el = np.full(views, SG_ELEVATION)
    eye = SG_EYE_DIST * np.stack([np.cos(el) * np.sin(az), np.sin(el),
                                  np.cos(el) * np.cos(az)], -1)
    return Camera.from_args(
        eye=torch.tensor(eye, dtype=torch.float32, device=dev),
        at=torch.zeros((views, 3), device=dev),
        up=torch.tensor([[0., 1., 0.]] * views, device=dev), fov=SG_FOV,
        width=size, height=size, device=dev), torch.tensor(
            eye, dtype=torch.float32, device=dev)


def sg_texture():
    """(1, 3, 256, 256) seeded texture; its first 64 rows are black."""
    tex = np.random.default_rng(SG_SEED).random(
        (1, 3, TEXTURE_RES, TEXTURE_RES), dtype=np.float32)
    tex[:, :, :TEXTURE_RES // 4] = 0.
    return tex


def sg_faces(size, views, dev):
    """uv_sphere(*SPHERE) seen by the path C cameras: per-face camera-space z
    (views, F, 3) and image coordinates (views, F, 3, 2), the face uvs and
    world positions, and the eyes."""
    s = uv_sphere(*SPHERE)
    cam, eye = sg_cameras(size, views, dev)
    v = torch.as_tensor(s.vertices[None], device=dev)
    faces = torch.as_tensor(s.faces, device=dev)
    fw = index_vertices_by_faces(v, faces)
    fuv = torch.as_tensor(s.uvs[s.face_uvs_idx][None], device=dev)
    vc = cam.extrinsics.transform(v)
    vi = cam.intrinsics.transform(vc)[..., :2]
    fvz = index_vertices_by_faces(vc, faces)[..., -1]
    fvi = index_vertices_by_faces(vi, faces)
    return fvz, fvi, fuv, fw, eye


def sg_geometry(size, views, dev):
    """The fixed geometry: ``rasterize(..., backend='fused')`` (K1) once per
    view of uv_sphere(*SPHERE), features uvs, normals and world positions;
    then the covered pixels' normal, view direction and nearest albedo.
    Returns a dict of the covered pixels' inputs and the face ids."""
    fvz, fvi, fuv, fw, eye = sg_faces(size, views, dev)
    maps, fids = [], []
    for b in range(views):
        m, fid = rasterize(size, size, fvz[b:b + 1], fvi[b:b + 1],
                           [fuv, fw, fw], backend='fused')
        maps.append(torch.cat(m, -1))
        fids.append(fid)
    maps, fid = torch.cat(maps), torch.cat(fids)
    return sg_pixels(maps, fid, eye, torch.as_tensor(sg_texture(),
                                                     device=dev))


def sg_k1_vs_plain(dev, card):
    """K1 against its plain version on path C's own inputs: for each view,
    the build_face_tiles that ``rasterize(..., backend='fused')`` makes at
    IMAGE_C^2 (rasterize's defaults, no soft mask).  Returns the max
    |dprod| and K1's time over the views (one launch each)."""
    fvz, fvi, _, _, _ = sg_faces(IMAGE_C, VIEWS, dev)
    fids_k, fids_p, dprod, k_ms, p_ms = [], [], 0., 0., 0.
    for b in range(VIEWS):
        with torch.no_grad():
            vt, tr, _, cbb, _, _ = FU.build_face_tiles(
                fvz[b:b + 1], fvi[b:b + 1] * MULT,
                torch.ones((1, fvz.shape[1]), dtype=torch.bool, device=dev),
                IMAGE_C, IMAGE_C, MULT, BOXLEN * MULT)
        args = (vt.float().contiguous(), tr, cbb.float().contiguous(),
                IMAGE_C, IMAGE_C, MULT, EPS, SIGMAINV, False)
        fid_k, prod_k = FU._fused_forward_cuda(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fid_p, prod_p = FU._fused_forward_torch(*args)
        end.record()
        torch.cuda.synchronize()
        p_ms += start.elapsed_time(end)
        k_ms += time_ms(lambda: FU._fused_forward_cuda(*args), 20)
        dprod = max(dprod, (prod_k - prod_p).abs().max().item())
        fids_k.append(fid_k)
        fids_p.append(fid_p)
    fid_k, fid_p = torch.cat(fids_k), torch.cat(fids_p)
    mismatch = (fid_k != fid_p).float().mean().item()
    print(f'[{card}] K1 vs plain on path C\'s inputs ({VIEWS} views, '
          f'{IMAGE_C}x{IMAGE_C}, no soft mask): face_idx mismatch share '
          f'{mismatch:.3e} (limit {K1_FID_MISMATCH_MAX:g}), max|dprod| '
          f'{dprod:.3e} (limit {K1_PROD_MAX:g}); covered pixels '
          f'{(fid_k >= 0).float().mean().item():.4f}; K1 {k_ms:.4f} ms for '
          f'the {VIEWS} launches, plain {p_ms:.3f} ms (one run)')
    _check(mismatch <= K1_FID_MISMATCH_MAX,
           'K1 face_idx mismatch share on path C')
    _check(dprod <= K1_PROD_MAX, 'K1 max |dprod| on path C')
    return dprod, k_ms, p_ms


def sg_pixels(maps, fid, eye, texture):
    """Covered pixels of the (B, H, W, 2 + 3 + 3) uv/normal/position maps:
    unit normals, unit view directions to the eye, nearest albedo."""
    cov = fid.reshape(-1) >= 0
    view_of = torch.arange(fid.shape[0], device=fid.device) \
        .repeat_interleave(fid[0].numel())[cov]
    px = maps.reshape(-1, maps.shape[-1])[cov]
    nrm = px[:, 2:5] / clip(torch.linalg.norm(px[:, 2:5], dim=-1,
                                              keepdim=True), 1e-12)
    view = eye[view_of] - px[:, 5:8]
    view = view / torch.linalg.norm(view, dim=-1, keepdim=True)
    albedo = texture_mapping(px[None, :, 0:2], texture, mode='nearest')[0]
    n = nrm.shape[0]
    return dict(fid=fid, maps=maps, normal=nrm, view=view, albedo=albedo,
                roughness=torch.full((n,), SG_ROUGHNESS, device=fid.device),
                spec=torch.full((n, 3), SG_SPEC, device=fid.device))


def sg_lobes(seed):
    """32 SG lobes: amplitude (32, 3), azimuth, elevation, sharpness."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.5, 2., (SG_LOBES, 3)).astype(np.float32),
            rng.uniform(0., 2. * np.pi, SG_LOBES).astype(np.float32),
            rng.uniform(-1., 1.3, SG_LOBES).astype(np.float32),
            rng.uniform(5., 30., SG_LOBES).astype(np.float32)]


def sg_shade(px, amp, az, el, sharp):
    """SG diffuse (inner product) + GGX specular of the covered pixels."""
    d = torch.stack(spherical2cartesian(az, el), dim=-1)
    return (sg_diffuse_inner_product(amp, d, sharp, px['normal'],
                                     px['albedo'])
            + sg_warp_specular_term(amp, d, sharp, px['normal'],
                                    px['roughness'], px['view'], px['spec']))


def sg_step(px, params, target, mark=lambda: None):
    """shade -> masked MSE -> backward; returns the loss; ``mark()`` after
    the forward and after the backward."""
    for p in params:
        p.grad = None
    loss = torch.mean((sg_shade(px, *params) - target) ** 2)
    mark()
    loss.backward()
    mark()
    return loss


def sg_start(dev):
    """The trained lobes: the ground truth's, perturbed (leaf tensors)."""
    gt = sg_lobes(SG_SEED + 1)
    rng = np.random.default_rng(SG_SEED + 2)
    start = [gt[0] * rng.uniform(0.5, 1.5, gt[0].shape),
             gt[1] + rng.normal(0., 0.3, SG_LOBES),
             gt[2] + rng.normal(0., 0.2, SG_LOBES),
             gt[3] * rng.uniform(0.7, 1.3, SG_LOBES)]
    return gt, [torch.tensor(x.astype(np.float32), device=dev,
                             requires_grad=True) for x in start]


def sg_step0(dev):
    """Step 0 at SG_STEP0 on the card against the CPU: the geometry on each
    (face ids within K1's mismatch limit, maps equal where they agree), then
    the shading step on the card's pixels on both devices."""
    size, views = SG_STEP0['image'], SG_STEP0['views']
    g = sg_geometry(size, views, dev)
    c = sg_geometry(size, views, 'cpu')
    mism = (g['fid'].cpu() != c['fid']).float().mean().item()
    same = (g['fid'].cpu() == c['fid']).reshape(-1) & (c['fid'].reshape(-1)
                                                       >= 0)
    merr = (g['maps'].cpu().reshape(-1, 8)[same]
            - c['maps'].reshape(-1, 8)[same]).abs().max().item()
    _check(mism <= K1_FID_MISMATCH_MAX, 'path C step 0: face ids, card vs '
           'CPU')
    _check(merr <= SG_MAP_ATOL, 'path C step 0: uv/normal/position maps')
    gt, _ = sg_start('cpu')
    res = {}
    for where in (dev, 'cpu'):
        px = {k: v.to(where) for k, v in g.items()}
        target = sg_shade(px, *[torch.as_tensor(x, device=where)
                                for x in gt])
        params = sg_start(where)[1]
        loss = sg_step(px, params, target)
        res[str(where)] = (loss.item(), [p.grad.cpu() for p in params])
    (lg, gg), (lc, gc) = res[str(dev)], res['cpu']
    rel = abs(lg - lc) / abs(lc)
    grel = max(_close_grads(a, b, f'path C step 0: d/d{n}') for a, b, n in
               zip(gg, gc, ('amplitude', 'azimuth', 'elevation',
                            'sharpness')))
    print(f'path C step 0 ({views} view, {size}x{size}, '
          f'{g["normal"].shape[0]} covered pixels): face ids card vs CPU '
          f'mismatch share {mism:.2e}, maps max|d| {merr:.2e}; loss '
          f'{lg:.7f} vs {lc:.7f} (rel {rel:.2e}, limit {SG_LOSS_RTOL:g}); '
          f'gradients max|d|/max|g| {grel:.2e} (limit {SG_GRAD_REL:g})')
    _check(rel <= SG_LOSS_RTOL, 'path C step 0: loss card vs CPU')
    _check(grel <= SG_GRAD_REL, 'path C step 0: gradients card vs CPU')


def path_c(dev, card):
    """Phase 19: path C through the entry points at 512^2, 4 views, 32
    lobes: the geometry (K1 once per view, launches counted), the target
    from the ground-truth lobes, 5 Adam steps; step 0 against the CPU;
    times, stage split, kernels per step, idle share, peak memory."""
    torch.cuda.synchronize()
    for k in FU.LAUNCHES:
        FU.LAUNCHES[k] = 0
    px = sg_geometry(IMAGE_C, VIEWS, dev)
    gt, params = sg_start(dev)
    with torch.no_grad():
        target = sg_shade(px, *[torch.as_tensor(x, device=dev) for x in gt])
    opt = torch.optim.Adam(params, lr=SG_LR)
    losses = []
    for _ in range(STEPS):
        losses.append(sg_step(px, params, target).item())
        opt.step()
    torch.cuda.synchronize()
    launches = FU.LAUNCHES['fwd']
    n = px['normal'].shape[0]
    print(f'path C scene: uv_sphere{SPHERE} (the DIB-R cell\'s sphere), '
          f'{VIEWS} pinhole cameras '
          f'{IMAGE_C}x{IMAGE_C}, 70 deg fov, 256^2 texture with black rows; '
          f'{n} covered pixels ({n / (VIEWS * IMAGE_C ** 2):.4f}), '
          f'{SG_LOBES} lobes; {STEPS} Adam steps (lr {SG_LR:g}): MSE '
          + ', '.join(f'{x:.7f}' for x in losses)
          + f'; K1 launches {launches} (K2 {FU.LAUNCHES["bwd"]})')
    _check(launches == VIEWS, 'K1 launched once per view on path C')
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           'path C: the loss falls')
    _check(all(bool(torch.isfinite(p).all()) for p in params),
           'path C: lobes finite')
    k1_err, k1_ms, k1_plain_ms = sg_k1_vs_plain(dev, card)
    sg_step0(dev)

    step_ms = time_ms(lambda: sg_step(px, params, target), 3)
    geo_ms = time_ms(lambda: sg_geometry(IMAGE_C, VIEWS, dev), 3)
    d = torch.stack(spherical2cartesian(params[1], params[2]), -1).detach()
    a, s_ = params[0].detach(), params[3].detach()
    diff_ms = time_ms(lambda: sg_diffuse_inner_product(
        a, d, s_, px['normal'], px['albedo']), 3)
    spec_ms = time_ms(lambda: sg_warp_specular_term(
        a, d, s_, px['normal'], px['roughness'], px['view'], px['spec']), 3)

    def adam_step(mark):
        sg_step(px, params, target, mark)
        opt.step()
        mark()

    split = check_parts('path C step', ('forward', 'backward', 'Adam'),
                        *step_parts_ms(adam_step))
    torch.cuda.reset_peak_memory_stats()
    sg_step(px, params, target)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[{card}] path C step (shade {n} pixels x {SG_LOBES} lobes -> '
          f'MSE -> backward): {step_ms:.3f} ms; with the Adam update, by '
          f'part: {split}; on their own: diffuse {diff_ms:.3f}, specular '
          f'{spec_ms:.3f} ms (forwards, no grad); the geometry, once per run '
          f'({VIEWS} rasterizations through K1 + pixel gathers) '
          f'{geo_ms:.3f} ms; '
          f'peak device memory of a step {peak:.3f} GiB')
    idle = step_profile(lambda: sg_step(px, params, target), card)
    return dict(launches=launches, step_ms=step_ms, idle=idle, peak=peak,
                k1_err=k1_err, k1_ms=k1_ms, k1_plain_ms=k1_plain_ms)


# ---------------------------------------------------------------------------
# Path D: DMTet chamfer fit: marching tetrahedra -> sample_points ->
# chamfer to an ellipsoid's points + uniform-Laplacian term -> Adam on the SDF

def dmtet_scene(n, dev):
    """tet_grid(n) of [-0.5, 0.5]^3, the sphere SDF of radius DMTET_RADIUS,
    and DMTET_TARGET points sampled on the ellipsoid."""
    v, tets = tet_grid(n, -0.5, 0.5)
    sdf = (np.linalg.norm(v, axis=-1) - DMTET_RADIUS).astype(np.float32)
    e = uv_sphere(*DMTET_ELLIPSOID_MESH)
    target, _ = sample_points(
        (e.vertices * DMTET_ELLIPSOID).astype(np.float32)[None], e.faces,
        DMTET_TARGET, generator=torch.Generator().manual_seed(DMTET_SEED),
        device='cpu')                   # the same points on every device
    return dict(v=torch.as_tensor(v[None], device=dev), tets=tets,
                sdf=torch.tensor(sdf[None], device=dev),
                target=target.to(dev))


def dmtet_loss(scene, sdf, draw, mark=lambda: None):
    """marching_tetrahedra -> points on the surface (``draw(v, f)``) ->
    chamfer to the target + DMTET_LAP_W x the mean squared uniform-Laplacian
    displacement; ``mark()`` after each of the four stages.  Returns (loss,
    surface vertices, faces)."""
    verts, faces = marching_tetrahedra(scene['v'], scene['tets'], sdf)
    v, f = verts[0][None], faces[0]
    mark()
    pts = draw(v, f)
    mark()
    chamfer = chamfer_distance(pts, scene['target'])[0]
    mark()
    lap = uniform_laplacian_smoothing(v, f) - v
    loss = chamfer + DMTET_LAP_W * (lap ** 2).sum(-1).mean()
    mark()
    return loss, v, f


def dmtet_step(scene, sdf, gen, mark=lambda: None):
    sdf.grad = None
    loss, _, _ = dmtet_loss(scene, sdf, lambda v, f: sample_points(
        v, f, DMTET_SAMPLES, generator=gen)[0], mark)
    loss.backward()
    mark()
    return loss


DMTET_STAGES = ('marching_tetrahedra', 'sample_points', 'chamfer_distance',
                'laplacian term', 'backward')


def dmtet_step0(dev):
    """Step 0 at tet_grid(DMTET_STEP0_GRID), card vs CPU, with the same
    face choices, u and v through _base_sample_points_selected_faces."""
    res = {}
    for where in (dev, 'cpu'):
        sc = dmtet_scene(DMTET_STEP0_GRID, where)
        sc['target'] = sc['target'][:, :DMTET_STEP0_TARGET]
        sdf = sc['sdf'].clone().requires_grad_()

        def draw(v, f):
            rng = np.random.default_rng(DMTET_SEED + 1)
            choice = torch.as_tensor(rng.integers(0, f.shape[0],
                                                  DMTET_STEP0_SAMPLES),
                                     device=v.device)
            u = torch.as_tensor(np.sqrt(rng.random(
                (1, DMTET_STEP0_SAMPLES, 1))).astype(np.float32),
                device=v.device)
            w = torch.as_tensor(rng.random((1, DMTET_STEP0_SAMPLES, 1))
                                .astype(np.float32), device=v.device)
            fv = v[:, f[choice]]
            return _base_sample_points_selected_faces(
                (fv[:, :, 0], fv[:, :, 1], fv[:, :, 2]), u=u, v=w)[0]

        loss, v, f = dmtet_loss(sc, sdf, draw)
        loss.backward()
        res[str(where)] = (loss.item(), sdf.grad.cpu(), f.cpu(),
                           v.detach().cpu())
    (lg, gg, fg, vg), (lc, gc, fc, vc) = res[str(dev)], res['cpu']
    _check(torch.equal(fg, fc), 'path D step 0: faces card vs CPU')
    verr = (vg - vc).abs().max().item()
    rel = abs(lg - lc) / abs(lc)
    grel = _close_grads(gg, gc, 'path D step 0: d/dsdf')
    print(f'path D step 0 (tet_grid({DMTET_STEP0_GRID}), {fg.shape[0]} '
          f'faces, {DMTET_STEP0_SAMPLES} samples, {DMTET_STEP0_TARGET} '
          f'target points): faces equal, vertices max|d| {verr:.2e}; loss '
          f'{lg:.7f} vs {lc:.7f} (rel {rel:.2e}, limit {DMTET_LOSS_RTOL:g});'
          f' SDF gradient max|d|/max|g| {grel:.2e} (limit '
          f'{DMTET_GRAD_REL:g})')
    _check(verr <= MT_VERT_ATOL, 'path D step 0: surface vertices')
    _check(rel <= DMTET_LOSS_RTOL, 'path D step 0: loss card vs CPU')
    _check(grel <= DMTET_GRAD_REL, 'path D step 0: gradient card vs CPU')


def path_d(dev, card):
    """Phase 20: path D at tet_grid(64): 5 Adam steps on the SDF, the loss
    must fall; edge lengths and point-to-mesh distances of the final
    surface; step 0 against the CPU; times, stage split, kernels per step,
    idle share, peak memory."""
    sc = dmtet_scene(DMTET_GRID, dev)
    sdf = sc['sdf'].clone().requires_grad_()
    gen = torch.Generator(device=dev).manual_seed(DMTET_SEED)
    opt = torch.optim.Adam([sdf], lr=DMTET_LR)
    losses = []
    for _ in range(STEPS):
        losses.append(dmtet_step(sc, sdf, gen).item())
        opt.step()
    torch.cuda.synchronize()
    with torch.no_grad():
        verts, faces = marching_tetrahedra(sc['v'], sc['tets'], sdf)
        v, f = verts[0][None], faces[0]
        ael = average_edge_length(v, f)
        p2m, fidx, dtype = point_to_mesh_distance(
            sc['target'][:, :DMTET_P2M], v[:, f])
    print(f'path D scene: tet_grid({DMTET_GRID}) of [-0.5, 0.5]^3 '
          f'({len(sc["tets"])} tets, {sc["v"].shape[1]} vertices), sphere '
          f'SDF r={DMTET_RADIUS}; target {DMTET_TARGET} points on the '
          f'ellipsoid {DMTET_ELLIPSOID} (uv_sphere{DMTET_ELLIPSOID_MESH}); '
          f'{DMTET_SAMPLES} samples a step; {STEPS} Adam steps (lr '
          f'{DMTET_LR:g}): loss ' + ', '.join(f'{x:.7f}' for x in losses)
          + f'; final surface {v.shape[1]} vertices, {f.shape[0]} faces, '
          f'mean edge length {ael.mean().item():.6f}; {DMTET_P2M} target '
          f'points to it: mean squared distance {p2m.mean().item():.4e}, '
          f'max {p2m.max().item():.4e}, distance types '
          f'{torch.bincount(dtype.reshape(-1).long(), minlength=7).tolist()}')
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           'path D: the loss falls')
    _check(bool(torch.isfinite(p2m).all()) and bool(torch.isfinite(
        ael).all()), 'path D: metrics finite')
    dmtet_step0(dev)

    stages, steps = step_parts_ms(
        lambda mark: dmtet_step(sc, sdf, gen, mark), 3)
    check_parts('path D step', DMTET_STAGES, stages, steps)
    step_ms = float(steps.mean())
    with torch.no_grad():
        p2m_ms = time_ms(lambda: point_to_mesh_distance(
            sc['target'][:, :DMTET_P2M], v[:, f]), 1)
    torch.cuda.reset_peak_memory_stats()
    dmtet_step(sc, sdf, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[{card}] path D step (marching tets -> {DMTET_SAMPLES} samples '
          f'-> chamfer to {DMTET_TARGET} + Laplacian -> backward): '
          f'{step_ms:.3f} ms (3 steps: '
          + ', '.join(f'{x:.3f}' for x in steps) + '); by stage, mean (min-'
          'max) ms: ' + '; '.join(
              f'{n} {c.mean():.3f} ({c.min():.3f}-{c.max():.3f})'
              for n, c in zip(DMTET_STAGES, stages.T))
          + f'; point_to_mesh_distance of {DMTET_P2M} points to '
          f'{f.shape[0]} faces {p2m_ms:.3f} ms; peak device memory of a '
          f'step {peak:.3f} GiB')
    idle = step_profile(lambda: dmtet_step(sc, sdf, gen), card)
    return dict(step_ms=step_ms, idle=idle, peak=peak)


# ---------------------------------------------------------------------------
# Path E: occupancy evaluation of a mesh: check_sign on the 128^3 cell
# centres, the voxel-grid ops, marching cubes, the metrics

def cell_centres(res, dev):
    """(1, res^3, 3) centres of the res^3 cells of [-0.5, 0.5]^3."""
    c = (torch.arange(res, device=dev, dtype=torch.float32) + 0.5) / res \
        - 0.5
    return torch.stack(torch.meshgrid(c, c, c, indexing='ij'),
                       -1).reshape(1, -1, 3)


def occ_mesh(dev):
    s = uv_sphere(*SPHERE)
    return (torch.as_tensor((s.vertices * OCC_RADIUS)[None], device=dev),
            torch.as_tensor(s.faces, device=dev))


def mc_world(v, res):
    """Marching-cubes vertices (padded-grid frame) to world coordinates."""
    return (v - 0.5) / res - 0.5


def occupancy_eval(dev, res):
    """The evaluation through the entry points; returns its results and
    the stage times on the host clock (each stage synchronised)."""
    t, out = {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        t[name] = (time.perf_counter() - t0) * 1e3
        return r

    verts, faces = occ_mesh(dev)
    pts = cell_centres(res, dev)
    occ = stage('check_sign', lambda: check_sign(verts, faces, pts)) \
        .reshape(1, res, res, res)
    down = stage('downsample x2', lambda: downsample(occ, 2))
    surf = stage('extract_surface', lambda: extract_surface(occ))
    filled = stage('fill', lambda: fill(surf))
    odms = stage('extract_odms', lambda: extract_odms(occ))
    hull = stage('project_odms', lambda: project_odms(odms))
    mv, mf = stage('marching cubes', lambda: voxelgrids_to_trianglemeshes(
        occ))
    cv, cf = stage('cubic meshes', lambda: voxelgrids_to_cubic_meshes(occ))
    vox = stage('trianglemeshes_to_voxelgrids', lambda: fill(
        trianglemeshes_to_voxelgrids(
            verts, faces, res,
            origin=torch.full((1, 3), -0.5 + 0.5 / res, device=dev),
            scale=torch.full((1,), (res - 1) / res, device=dev)).bool()))
    score = stage('iou', lambda: iou(occ, vox))
    gen = torch.Generator(device=dev).manual_seed(OCC_SEED)
    mc_pts, src_pts = stage('sample_points', lambda: (
        sample_points(mc_world(mv[0], res)[None], mf[0], OCC_SAMPLES,
                      generator=gen)[0],
        sample_points(verts, faces, OCC_SAMPLES, generator=gen)[0]))
    ch = stage('chamfer_distance', lambda: chamfer_distance(mc_pts, src_pts))
    fs = stage('f_score', lambda: f_score(src_pts, mc_pts,
                                          radius=OCC_FSCORE_RADIUS))
    p2m = stage('point_to_mesh_distance', lambda: point_to_mesh_distance(
        mc_pts, verts[:, faces]))
    out.update(pts=pts, occ=occ, down=down, surf=surf, filled=filled,
               hull=hull, mc=(mv[0], mf[0]), cubic=(cv[0], cf[0]), vox=vox,
               iou=score.item(), chamfer=ch.item(), f_score=fs.item(),
               p2m=p2m[0])
    return out, t


def occ_card_vs_cpu(dev):
    """check_sign and marching cubes at OCC_PARITY_RES, card vs CPU."""
    res = {}
    for where in (dev, 'cpu'):
        verts, faces = occ_mesh(where)
        pts = cell_centres(OCC_PARITY_RES, where)
        occ = check_sign(verts, faces, pts).reshape((1,) + (
            OCC_PARITY_RES,) * 3)
        mv, mf = voxelgrids_to_trianglemeshes(occ)
        res[str(where)] = (occ.cpu(), mv[0].cpu(), mf[0].cpu())
    (og, vg, fg), (oc, vc, fc) = res[str(dev)], res['cpu']
    _check(torch.equal(og, oc), 'path E: check_sign card vs CPU')
    _check(torch.equal(fg, fc), 'path E: marching cubes faces card vs CPU')
    verr = (vg - vc).abs().max().item()
    _check(verr <= MT_VERT_ATOL, 'path E: marching cubes vertices')
    print(f'path E at {OCC_PARITY_RES}^3, card vs CPU: check_sign equal '
          f'({int(oc.sum())} inside), marching cubes {fc.shape[0]} faces '
          f'equal, vertices max|d| {verr:.2e}')


def path_e(dev, card):
    """Phase 21: path E at 128^3 through the entry points, its checks,
    card vs CPU at 32^3, stage times, kernels, idle share, peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, t_cold = occupancy_eval(dev, OCC_RES)
    cold = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    r = torch.linalg.norm(out['pts'][0], dim=-1)
    occ = out['occ'].reshape(-1)
    far = (r - OCC_RADIUS).abs() > OCC_SHELL
    wrong = int((occ[far] != (r[far] < OCC_RADIUS)).sum())
    mv, mf = out['mc']
    print(f'path E: check_sign of {r.shape[0]} cell centres ({OCC_RES}^3) '
          f'against uv_sphere{SPHERE} x {OCC_RADIUS}: {int(occ.sum())} '
          f'inside; {wrong} of {int(far.sum())} points farther than '
          f'{OCC_SHELL:g} from the sphere disagree with |p| < '
          f'{OCC_RADIUS}; downsample x2 mean {out["down"].mean().item():.6f}'
          f'; surface {int(out["surf"].sum())} voxels, fill(surface) equal '
          f'to the solid: {torch.equal(out["filled"], out["occ"])}; ODM '
          f'hull {int(out["hull"].sum())} voxels; marching cubes '
          f'{mv.shape[0]} vertices, {mf.shape[0]} faces; cubic mesh '
          f'{out["cubic"][0].shape[0]} vertices, {out["cubic"][1].shape[0]}'
          f' faces; iou against the filled surface voxelization '
          f'{out["iou"]:.6f}; marching cubes vs source mesh, '
          f'{OCC_SAMPLES} samples each: chamfer {out["chamfer"]:.4e}, '
          f'f_score (r={OCC_FSCORE_RADIUS:g}) {out["f_score"]:.6f}, '
          f'point_to_mesh mean squared distance '
          f'{out["p2m"].mean().item():.4e}')
    _check(wrong == 0, 'path E: check_sign off the surface shell')
    _check(torch.equal(out['filled'], out['occ']),
           'path E: fill(extract_surface(x)) == x for the solid sphere')
    _check(bool((out['hull'] >= out['occ']).all()),
           'path E: the ODM hull holds the solid')
    _check(out['iou'] > OCC_IOU_MIN, 'path E: iou against the voxelization')
    _check(out['f_score'] > 0.5 and np.isfinite(out['chamfer']),
           'path E: metrics')
    occ_card_vs_cpu(dev)
    # a warm evaluation between CUDA events (the stages synchronise)
    t = {}
    wall = time_ms(lambda: t.update(occupancy_eval(dev, OCC_RES)[1]), 1,
                   warmup=0)
    print(f'[{card}] path E, one warm evaluation: {wall:.3f} ms (CUDA '
          f'events; the first, cold, {cold:.3f} ms on the host clock); by '
          f'stage (ms, host clock, each synchronised): ' + ', '.join(
              f'{k} {v:.3f}' for k, v in t.items())
          + f'; cold check_sign {t_cold["check_sign"]:.3f}; peak device '
          f'memory {peak:.3f} GiB')
    idle = step_profile(lambda: occupancy_eval(dev, OCC_RES), card,
                        steps=1)
    return dict(wall_ms=wall, stages=t, idle=idle, peak=peak)


# ---------------------------------------------------------------------------
# Path F: a DIB-R fit that logs a Timelapse, resumes from a checkpoint and
# ends in a MISE occupancy extraction through the triangle hash

PF_STEPS = 20
PF_LOG_EVERY = 5            # Timelapse at iterations 0, 5, 10, 15
PF_SAVE_AT = 10             # checkpoint of the state step 10 starts from
PF_POINTS = 10_000          # sample_points logged as a point cloud
PF_SEED = 24
PF_BIG_SPHERE = (500, 251)  # 250,000 faces: the parse timing
PF_MISE = dict(init_res=32, upsampling_steps=3, bbox_dim=1.2)   # 257^3
PF_HASH_RES = 512
PF_PARITY_POINTS = 100_000  # MISE query points: hash against vectorised
PF_SHELL = 1e-3             # ... equal but within this of the surface


def _bits_equal(a, b):
    """Equality of two tensors of one dtype and device, float32 bitwise."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(_bits(a), _bits(b))
    return torch.equal(a, b)


def _tree_bits_equal(a, b):
    """Every tensor of two states bitwise equal, every other leaf equal."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and _bits_equal(a.detach(), b.detach())
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(
            _tree_bits_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(
            _tree_bits_equal(x, y) for x, y in zip(a, b))
    return a == b


def pf_import(dev, tmp):
    """The DIB-R cell's sphere through the native OBJ path onto the card;
    a 250,000-face sphere through the native and the Python parse."""
    s = uv_sphere(*SPHERE)
    path = write_sphere_obj(tmp, s)
    t0 = time.perf_counter()
    mesh = import_mesh(path, device=dev)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) * 1e3
    same = (mesh.vertices.device.type == torch.device(dev).type
            and torch.equal(mesh.vertices.cpu(), torch.as_tensor(s.vertices))
            and torch.equal(mesh.faces.cpu(), torch.as_tensor(s.faces))
            and torch.equal(mesh.face_uvs.cpu(),
                            torch.as_tensor(s.uvs[s.face_uvs_idx])))
    _check(same, 'path F: the native import equals the generator')
    big = uv_sphere(*PF_BIG_SPHERE)
    big_dir = os.path.join(tmp, 'big')
    os.makedirs(big_dir)
    big_path = write_sphere_obj(big_dir, big)
    t = {}
    for name, kw in (('native', {}), ('python', dict(with_materials=True))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = import_mesh(big_path, device=dev, **kw)
        torch.cuda.synchronize()
        t[name] = ((time.perf_counter() - t0) * 1e3, m)
    a, b = t['native'][1], t['python'][1]
    equal = all(_bits_equal(getattr(a, k), getattr(b, k)) for k in (
        'vertices', 'faces', 'uvs', 'face_uvs_idx'))
    print(f'path F import: uv_sphere{SPHERE} OBJ through the native '
          f'tokenizer onto the card {import_ms:.1f} ms (host clock), equal '
          f"to the generator's: {same}; uv_sphere{PF_BIG_SPHERE} "
          f'({b.faces.shape[0]} faces, {os.path.getsize(big_path)} bytes): '
          f'native parse + upload {t["native"][0]:.1f} ms, Python parse '
          f'(with_materials=True) + upload {t["python"][0]:.1f} ms (host '
          f'clock of the GPU machine), ratio '
          f'{t["python"][0] / t["native"][0]:.1f}; arrays bit-equal: {equal}')
    _check(equal, 'path F: native and Python parse equal')
    return mesh


def pf_checkpoint(scene, params, opt, ckdir, step):
    """Save the state at ``step`` (torch.save and npz), load both back,
    hold them bit-equal to the state in memory; a twin model and optimizer
    from the loaded state.  Returns (twin, twin_opt)."""
    state = {'params': params.as_params(), 'opt': opt.state_dict(),
             'step': step}
    t = {}
    t0 = time.perf_counter()
    ckpt.save(ckdir, state, step=step)
    t['save_ms'] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    npz = ckpt.save_npz(os.path.join(ckdir, 'params.npz'), params.as_params())
    t['save_npz_ms'] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = ckpt.load(ckdir, like=state)
    torch.cuda.synchronize()
    t['load_ms'] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back_npz = ckpt.load_npz(npz, device=params.vertices.device)
    torch.cuda.synchronize()
    t['load_npz_ms'] = (time.perf_counter() - t0) * 1e3
    same = _tree_bits_equal(state, back)
    same_npz = _tree_bits_equal(tuple(state['params']), tuple(back_npz))
    adam = back['opt']['state']
    print(f'path F checkpoint at step {step}: save {t["save_ms"]:.1f} ms, '
          f'load {t["load_ms"]:.1f} ms, save_npz {t["save_npz_ms"]:.1f} ms, '
          f'load_npz {t["load_npz_ms"]:.1f} ms (host clock); loaded state '
          f'bit-equal to memory: {same} (Adam step '
          f'{adam[0]["step"].item():g}, exp_avg, exp_avg_sq of '
          f'{len(adam)} parameters), npz params bit-equal: {same_npz}')
    _check(same, 'path F: checkpoint round trip bit-equal')
    _check(same_npz, 'path F: npz round trip bit-equal')
    twin = M.from_jax_params(*(np.zeros(tuple(p.shape), np.float32)
                               for p in back['params']),
                             device=params.vertices.device)
    twin.load_params(back['params'])
    twin_opt = torch.optim.Adam(twin.parameters(), lr=1.)
    twin_opt.load_state_dict(back['opt'])
    return twin, twin_opt


def pf_fit(scene, mesh, tl, ckdir):
    """The 20 Adam steps with the Timelapse and the checkpoint; the twin
    resumed from the checkpoint takes step PF_SAVE_AT beside the loop.
    Returns the losses, what was logged, the Timelapse write times, the
    resume comparison and step 0's kernel launches (kept)."""
    params = scene['params']
    opt = torch.optim.Adam(params.parameters(), lr=LR)
    gen = torch.Generator(device=params.vertices.device).manual_seed(PF_SEED)
    faces = scene['faces']
    losses, logged, t_log, resume = [], {}, {}, {}
    for step in range(PF_STEPS):
        if step % PF_LOG_EVERY == 0:
            v = params.vertices.detach()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tl.add_mesh_batch(iteration=step, category='fit',
                              vertices_list=[v], faces_list=[faces],
                              uvs_list=[mesh.uvs],
                              face_uvs_idx_list=[mesh.face_uvs_idx])
            t1 = time.perf_counter()
            pts = sample_points(v[None], faces, PF_POINTS,
                                generator=gen)[0][0]
            tl.add_pointcloud_batch(iteration=step, category='fit',
                                    pointcloud_list=[pts])
            t_log[step] = ((t1 - t0) * 1e3,
                           (time.perf_counter() - t1) * 1e3)
            logged[step] = (v.cpu().clone(), pts.cpu().clone())
        if step == PF_SAVE_AT:
            twin, twin_opt = pf_checkpoint(scene, params, opt, ckdir, step)
            loss_r, _ = _step(scene, twin)
            resume['loss'] = loss_r.item()
            resume['grads'] = [p.grad.clone() for p in twin.parameters()]
            twin_opt.step()
        with (kept_launches() if step == 0
              else contextlib.nullcontext()) as kept:
            loss, _ = _step(scene, params)
        if step == 0:
            first = kept
        if step == PF_SAVE_AT:
            resume['grads_mem'] = [p.grad.clone() for p in params.parameters()]
            before = [p.detach().clone() for p in params.parameters()]
        opt.step()
        losses.append(loss.item())
        if step == PF_SAVE_AT:
            resume['loss_mem'] = losses[-1]
            resume['params'] = [(a, b.detach().clone(), c.detach().clone())
                                for a, b, c in zip(before, params.parameters(),
                                                   twin.parameters())]
    return losses, logged, t_log, resume, first


def pf_check_resume(resume):
    """One step from the restored state against the same step from the
    state in memory: loss and gradients within step 0's card-vs-CPU limits,
    the Adam update within STEP0_GRAD_REL of its largest entry."""
    rel = abs(resume['loss'] - resume['loss_mem']) / abs(resume['loss_mem'])
    print(f'path F resume: step {PF_SAVE_AT} from the loaded checkpoint vs '
          f'from memory: loss {resume["loss"]:.7f} vs '
          f'{resume["loss_mem"]:.7f} (rel {rel:.2e}, limit '
          f'{STEP0_LOSS_RTOL:g})')
    _check(rel <= STEP0_LOSS_RTOL, 'path F: resumed loss')
    names = ('vertices', 'texture_map', 'sh_coeffs')
    for name, g_r, g_m, (p0, p_m, p_r) in zip(
            names, resume['grads'], resume['grads_mem'], resume['params']):
        g_scale = g_m.abs().max().item()
        g_err = (g_r - g_m).abs().max().item()
        u_scale = (p_m - p0).abs().max().item()
        u_err = (p_r - p_m).abs().max().item()
        print(f'  {name}: grad max|d| {g_err:.3e} of max|g| {g_scale:.3e}; '
              f'after the Adam step max|d| {u_err:.3e} of the largest update '
              f'{u_scale:.3e} (limits {STEP0_GRAD_REL:g} of each)')
        _check(g_scale > 0 and g_err <= STEP0_GRAD_REL * g_scale,
               f'path F: resumed gradient {name}')
        _check(u_err <= STEP0_GRAD_REL * u_scale,
               f'path F: resumed update {name}')


def pf_read_back(logdir, logged, dev):
    """TimelapseParser finds both categories and their timestamps; the
    vertices and points of the last sample read back bit for bit."""
    parser = TimelapseParser(logdir)
    times = [float(t) for t in range(0, PF_STEPS, PF_LOG_EVERY)]
    found = {k: [(b['category'], b['id']) for b in parser.dir_info[k]]
             for k in ('mesh', 'pointcloud')}
    stamps = {k: parser.get_timestamps(k, 'fit', 0) for k in found}
    last = max(logged)
    m = usd.import_mesh(parser.get_file_path('mesh', 'fit', 0), '/mesh_0',
                        time=last, device=dev)
    pc = usd.import_pointcloud(parser.get_file_path('pointcloud', 'fit', 0),
                               '/pointcloud_0', time=last, device=dev)
    v_ok = _bits_equal(m.vertices.cpu(), logged[last][0])
    p_ok = _bits_equal(pc.points.cpu(), logged[last][1])
    print(f'path F Timelapse read back: {found}, timestamps {stamps}; '
          f'iteration {last}: vertices bit-equal {v_ok}, points bit-equal '
          f'{p_ok}')
    _check(all(v == [('fit', 0)] for v in found.values()),
           'path F: TimelapseParser finds the mesh and the point cloud')
    _check(all(s == times for s in stamps.values()),
           'path F: Timelapse timestamps')
    _check(v_ok and p_ok, 'path F: Timelapse read back bit-equal')


def pf_occupancy(verts, faces, batches):
    """The MISE occupancy: check_sign(use_hash=True) of the fitted mesh,
    -1 inside, 1 outside; each query batch kept in ``batches``."""
    def sdf(x):
        batches.append(x)
        inside = check_sign(verts, faces, x[None], use_hash=True,
                            hash_resolution=PF_HASH_RES)[0]
        return 1. - 2. * inside.float()
    return sdf


def pf_extract(params, faces, dev, tmp):
    """MISE at 257^3 over the fitted mesh on the card and on the CPU; the
    hash stages timed on each level's query points; hash against the
    vectorised test on 100,000 query points; marching cubes and two USD
    round trips."""
    verts = params.vertices.detach()[None]
    batches = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = sdf_to_voxelgrids([pf_occupancy(verts, faces, batches)],
                             device=dev, **PF_MISE)
    torch.cuda.synchronize()
    mise_ms = (time.perf_counter() - t0) * 1e3
    counts = [x.shape[0] for x in batches]
    t0 = time.perf_counter()
    grid_cpu = sdf_to_voxelgrids(
        [pf_occupancy(verts.cpu(), faces.cpu(), [])], device='cpu',
        **PF_MISE)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(grid.cpu(), grid_cpu)
    side = PF_MISE['init_res'] * 2 ** PF_MISE['upsampling_steps'] + 1
    print(f'path F MISE: {side}^3 grid over the fitted mesh, query points '
          f'per level {counts} (of {side ** 3} grid points), '
          f'{int(grid.sum())} inside; on the card {mise_ms:.1f} ms (host '
          f'clock, MISE on the host, check_sign on the card), on the CPU '
          f'{cpu_ms:.1f} ms; card grid equal to the CPU grid: {same}')
    _check(grid.shape == (1, side, side, side), 'path F: MISE grid shape')
    _check(0 < int(grid.sum()) < grid.numel(), 'path F: MISE grid occupied')
    _check(same, 'path F: MISE grid card vs CPU')

    # the hash stages, replayed on each level's query points
    tris = verts[0][faces]
    tris_xy = tris[:, :, :2].cpu().numpy().astype(np.float64)
    stages = dict(build=0., query=0., device_test=0.)
    pairs = 0
    for x in batches:
        t0 = time.perf_counter()
        th = _native.TriangleHash(tris_xy, PF_HASH_RES)
        t1 = time.perf_counter()
        pidx, tidx = th.query(x[:, :2].cpu().numpy().astype(np.float64))
        t2 = time.perf_counter()
        stages['build'] += (t1 - t0) * 1e3
        stages['query'] += (t2 - t1) * 1e3
        pidx = torch.as_tensor(pidx, device=dev)
        tidx = torch.as_tensor(tidx, device=dev)
        pairs += pidx.shape[0]
        stages['device_test'] += time_ms(
            lambda: _hash_parity(tris, x, pidx, tidx), 1, warmup=0)
    print(f'path F hash stages over the {len(batches)} levels '
          f'({sum(counts)} points, {pairs} candidate pairs): hash build '
          f'{stages["build"]:.1f} ms, hash queries (with the xy copy to the '
          f'host) {stages["query"]:.1f} ms (host clock), device test '
          f'{stages["device_test"]:.3f} ms (CUDA events)')

    # hash against the vectorised test, but in the surface's shell
    pts = torch.cat(batches)
    pick = np.random.default_rng(PF_SEED).choice(
        pts.shape[0], min(PF_PARITY_POINTS, pts.shape[0]), replace=False)
    sub = pts[torch.as_tensor(pick, device=dev)][None]
    h = check_sign(verts, faces, sub, use_hash=True,
                   hash_resolution=PF_HASH_RES)[0]
    vec = check_sign(verts, faces, sub)[0]
    d2 = point_to_mesh_distance(sub, verts[:, faces])[0][0]
    shell = d2.sqrt() <= PF_SHELL
    differ = h != vec
    print(f'path F hash vs vectorised check_sign on {sub.shape[1]} MISE '
          f'query points: {int(differ.sum())} differ, all within '
          f'{PF_SHELL:g} of the surface: '
          f'{bool((shell | ~differ).all())} ({int(shell.sum())} points in '
          f'the shell)')
    _check(bool((shell | ~differ).all()),
           'path F: hash equals vectorised off the shell')

    # marching cubes, then the USD round trips
    t = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mv, mf = voxelgrids_to_trianglemeshes(grid)
    torch.cuda.synchronize()
    t['marching_cubes'] = (time.perf_counter() - t0) * 1e3
    path = os.path.join(tmp, 'extracted.usda')
    t0 = time.perf_counter()
    usd.export_mesh(path, vertices=mv[0], faces=mf[0])
    t['export_mesh'] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = usd.import_mesh(path, device=dev)
    torch.cuda.synchronize()
    t['import_mesh'] = (time.perf_counter() - t0) * 1e3
    mesh_ok = (_bits_equal(back.vertices, mv[0])
               and torch.equal(back.faces, mf[0].long()))
    surf = extract_surface(grid)[0]
    tl = Timelapse(os.path.join(tmp, 'extract'))
    t0 = time.perf_counter()
    tl.add_voxelgrid_batch(iteration=PF_STEPS, category='surface',
                           voxelgrid_list=[surf])
    t['add_voxelgrid_batch'] = (time.perf_counter() - t0) * 1e3
    vg_path = TimelapseParser(tl.logdir).get_file_path('voxelgrid',
                                                       'surface', 0)
    t0 = time.perf_counter()
    vg = usd.import_voxelgrid(vg_path, '/voxelgrid_0', time=PF_STEPS,
                              device=dev)
    torch.cuda.synchronize()
    t['import_voxelgrid'] = (time.perf_counter() - t0) * 1e3
    vg_ok = torch.equal(vg, surf.bool())
    print(f'path F USD round trips: marching cubes {mv[0].shape[0]} '
          f'vertices, {mf[0].shape[0]} faces ({os.path.getsize(path)} bytes '
          f'of USDA) export_mesh -> import_mesh bit-equal: {mesh_ok}; '
          f'extract_surface {int(surf.sum())} voxels -> add_voxelgrid_batch '
          f'-> import_voxelgrid equal: {vg_ok}; times (ms, host clock): '
          + ', '.join(f'{k} {v:.1f}' for k, v in t.items()))
    _check(mesh_ok, 'path F: USD mesh round trip')
    _check(vg_ok, 'path F: Timelapse voxel grid round trip')
    return mise_ms


def path_f(dev, card):
    """Phase 22: path F, a DIB-R fit that logs a Timelapse, resumes from a
    checkpoint and ends in a MISE occupancy extraction."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = pf_import(dev, tmp)
        scene = make_scene(dev, height=HEIGHT, views=VIEWS,
                           texture_res=TEXTURE_RES, mesh=mesh)
        # K1 and K2 against their plain versions on the first step's
        # inputs, one of the 4 views (not counted as path launches)
        vt, tr, ctr, cbb = kernel_inputs(scene)
        one = tuple(x[:1].contiguous() for x in (vt, tr, ctr, cbb))
        fid, prod, k1_err = check_forward(scene, one)
        _, k2_err = check_backward(scene, one, fid, prod)
        del vt, tr, ctr, cbb, one, fid, prod
        logdir = os.path.join(tmp, 'timelapse')
        tl = Timelapse(logdir)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = {}

        def fit():
            result['fit'] = pf_fit(scene, mesh, tl,
                                   os.path.join(tmp, 'ckpt'))

        idle = step_profile(fit, card, steps=1)
        fit_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        losses, logged, t_log, resume, first = result['fit']
        held, err = hold_against_plain(_epilogue_only(first),
                                       'path F step 0')
        print(f'path F step 0\'s E2, E3 launches held against plain: '
              f'{held}, max abs err {err}')
        _check(all(held[k] == 1 for k in STEP_EPILOGUE)
               and not held['sample'],
               'path F: step 0 launches E2 and E3 once each, E1 not')
        del first
        print(f'path F fit: {PF_STEPS} Adam steps (fused, {VIEWS} views, '
              f'{HEIGHT}^2, texture {TEXTURE_RES}^2) from the imported '
              f'sphere perturbed by 0.05 N(0, 1): loss {losses[0]:.6f} -> '
              f'{losses[-1]:.6f}; K1/K2/E1-E3/shading launches {launches} '
              f'(the loop and the resumed step); {fit_ms:.1f} ms for the '
              f'whole fit with '
              f'logging and the checkpoint, under the profiler (host '
              f'clock), card idle share {idle:.3f}')
        _check(losses[-1] < losses[0], 'path F: the loss falls')
        _check(all(launches[k] >= PF_STEPS + 1 for k in STEP_KERNELS),
               'path F: K1, K2, E2, E3 and the shading on every step')
        print('path F Timelapse writes (ms, host clock: mesh, point cloud): '
              + ', '.join(f'iteration {k} {a:.1f} / {b:.1f}'
                          for k, (a, b) in t_log.items()))
        pf_check_resume(resume)
        pf_read_back(logdir, logged, dev)
        step_ms = time_ms(lambda: _step(scene, scene['params']), 3)
        mise_ms = pf_extract(scene['params'], scene['faces'], dev, tmp)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[{card}] path F: step {step_ms:.3f} ms (CUDA events, fused, '
          f'{VIEWS} views, {HEIGHT}^2, after the fit); MISE '
          f'{mise_ms:.1f} ms (host clock); peak device memory {peak:.3f} '
          f'GiB')
    return dict(launches=launches, k1_err=k1_err, k2_err=k2_err,
                epi_err={k: err[k] for k in EPILOGUE}, step_ms=step_ms,
                idle=idle, peak=peak)


# ---------------------------------------------------------------------------
# Path G: datasets, synthetic views, viewers and the examples

PG_SYNSETS = ('02691156', '03001627')   # airplane, chair
PG_MODELS = 3                            # per synset; 2 of 3 train
PG_SPLIT = 0.67
PG_WORKERS = 2
PG_STEPS = 10
PG_LOG_EVERY = 5            # Timelapse at iterations 0 and 5
PG_POINTS = 10_000
PG_SEED = 25
PG_FIT_RADIUS = 0.45        # the fit starts from this sphere
PG_FOVY = math.pi / 4.      # make_views' default: the DIB-R cell's
PG_PROJ_RTOL = 1e-6         # cam_proj from the metadata against fovy's
PG_EVENTS = 8               # turntable rotate / zoom events
PG_VIEWER = dict(eye=(0., 0.5, 1.6), at=(0., 0., 0.), up=(0., 1., 0.),
                 fov=math.pi / 4.)
PG_EXAMPLES = (             # tests/test_examples.py's sizes, on the card
    ('camera_tour', [], 'round-trip close: True'),
    ('dibr_inverse_rendering', ['--height', '32', '--width', '32',
                                '--num-views', '2', '--steps', '3'], 'done'),
    ('dmtet_demo', ['--res', '4', '--steps', '2'], 'done'),
    ('spc_raytrace_demo', ['--level', '4', '--rays', '256'],
     'integrated features'),
    ('sg_lighting_demo', ['--size', '32', '--steps', '3'], 'done'),
)


def pg_render(vertices, views, faces, height, backend='fused'):
    """DIB-R of ``vertices`` in ``views``: (depth (B, H, W) from the
    camera, positive; soft mask; face_idx)."""
    B = views.camera_rot.shape[0]
    fvc, fvi, fn = prepare_vertices(
        vertices[None].expand(B, -1, -1), faces, views.camera_proj,
        camera_rot=views.camera_rot, camera_trans=views.camera_trans)
    depth, soft, fid = dibr_rasterization(
        height, height, fvc[..., 2], fvi, -fvc[..., 2:3], fn[..., 2],
        rast_backend=backend)
    return depth[..., 0], soft, fid


def pg_targets(vertices, views, faces, height):
    """The silhouette (int32 0/1) and linear depth (0 off the mesh) of
    ``vertices``, through K1."""
    with torch.no_grad():
        depth, _, fid = pg_render(vertices, views, faces, height)
        hit = fid >= 0
        return hit.to(torch.int32), torch.where(hit, depth, 0.)


def pg_loss(vertices, views, faces, sil, depth, height, backend='fused'):
    """Silhouette and depth: 1 - IoU of the soft mask (K1 forward, K2
    backward) + the L1 of the interpolated depth where both cover."""
    d, soft, fid = pg_render(vertices, views, faces, height, backend)
    both = (fid >= 0) & (sil > 0)
    l1 = (torch.where(both, (d - depth).abs(), 0.).sum()
          / both.sum().clamp(min=1))
    return mask_iou(soft, sil.float()) + l1


def pg_corpus(tmp):
    """The ShapeNetV2, ModelNet and SHREC16 trees."""
    t0 = time.perf_counter()
    shapenet = write_shapenet_v2(os.path.join(tmp, 'shapenet'), PG_SYNSETS,
                                 PG_MODELS, SPHERE, PG_SEED)
    modelnet = write_modelnet(os.path.join(tmp, 'modelnet'), ['chair'], 2,
                              SPHERE)
    shrec = write_shrec16(os.path.join(tmp, 'shrec16'), PG_SYNSETS[:1], 2,
                          SPHERE)
    ms = (time.perf_counter() - t0) * 1e3
    size = sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(tmp) for f in fs)
    nf = len(next(iter(shapenet.values())).faces)
    print(f'path G corpus: ShapeNetV2 {len(PG_SYNSETS)} synsets x '
          f'{PG_MODELS} models, ModelNet 2 OFF, SHREC16 2 OBJ, each '
          f'uv_sphere{SPHERE} deformed ({nf} faces), {size} bytes written '
          f'in {ms:.1f} ms (host clock)')
    return shapenet, modelnet, shrec


def pg_load(tmp, shapenet, modelnet, shrec, dev):
    """ShapeNetV2 -> ProcessedDataset -> CachedDataset (spawned workers),
    cold and warm; CombinationDataset of ModelNet and SHREC16; a DataLoader
    onto the card.  Returns the training meshes on the card."""
    root = os.path.join(tmp, 'shapenet')
    base = ShapeNetV2(root, train=True, split=PG_SPLIT, device='cpu')
    expected = [shapenet[(s, m)] for s in PG_SYNSETS
                for m in range(int(PG_MODELS * PG_SPLIT))]
    _check(len(base) == len(expected), 'path G: ShapeNetV2 split')
    calls = os.path.join(tmp, 'calls')
    cache_dir = os.path.join(tmp, 'cache')
    t = {}
    for run in ('cold', 'warm'):
        log = os.path.join(calls, run)
        counted = CountedDataset(ProcessedDataset(base, mesh_arrays), log)
        t0 = time.perf_counter()
        cache = CachedDataset(counted, cache_dir, save_on_disk=True,
                              num_workers=PG_WORKERS, device='cpu')
        t[run] = ((time.perf_counter() - t0) * 1e3,
                  CountedDataset.calls(log))
    print(f'path G CachedDataset (save_on_disk=True, {PG_WORKERS} spawned '
          f'workers): cold {t["cold"][0]:.1f} ms with {t["cold"][1]} base '
          f'getter calls, warm {t["warm"][0]:.1f} ms with {t["warm"][1]} '
          f'(host clock; start-up times: the cold one is mostly the '
          f'workers\' spawn and imports)')
    _check(t['cold'][1] == len(base) + 1,
           'path G: the cold cache calls the getter once per item + probe')
    _check(t['warm'][1] == 1,
           'path G: the warm cache calls the getter only for its probe')

    combo = CombinationDataset([ModelNet(os.path.join(tmp, 'modelnet'),
                                         device='cpu'),
                                SHREC16(os.path.join(tmp, 'shrec16'),
                                        device='cpu')])
    ok = all(torch.equal(a['mesh'].faces, torch.as_tensor(
        modelnet[('chair', i)].faces)) and torch.equal(
        b['mesh'].vertices, torch.as_tensor(shrec[(PG_SYNSETS[0], i)]
                                            .vertices))
        for i, (a, b) in enumerate(combo))
    print(f'path G CombinationDataset(ModelNet, SHREC16): {len(combo)} '
          f'pairs, labels {[p[0]["label"] for p in combo]}, '
          f'{[p[1]["synset"] for p in combo]}; meshes as written: {ok}')
    _check(ok, 'path G: ModelNet and SHREC16 meshes as written')

    loader = torch.utils.data.DataLoader(cache, batch_size=1,
                                         num_workers=PG_WORKERS,
                                         pin_memory=True)
    models = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in loader:
        models.append({k: v[0].to(dev, non_blocking=True)
                       for k, v in batch.items()})
    torch.cuda.synchronize()
    dl_s = time.perf_counter() - t0
    same = all(torch.equal(m['vertices'].cpu(), torch.as_tensor(s.vertices))
               and torch.equal(m['faces'].cpu(), torch.as_tensor(s.faces))
               for m, s in zip(models, expected))
    print(f'path G DataLoader ({PG_WORKERS} workers, pin_memory, '
          f'non_blocking copies): {len(models)} meshes in {dl_s * 1e3:.1f} '
          f'ms (host clock; a start-up time, the workers\' spawn included, '
          f'not a rate); equal to the written meshes: {same}')
    _check(same and len(models) == len(expected),
           'path G: the DataLoader gives the written meshes')
    return models


def pg_views(models, dev, tmp):
    """Each model's 4 views at 512^2 through K1, written as synthetic
    views and read back on the card; the cameras from the metadata.
    Returns the first model's (views, silhouettes, depths)."""
    views = M.make_views(VIEWS, fovy=PG_FOVY, device=dev)
    t = dict(render=0., write=0., read=0.)
    first = None
    for j, m in enumerate(models):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sil, depth = pg_targets(m['vertices'], views, m['faces'], HEIGHT)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        directory = os.path.join(tmp, 'views', str(j))
        for i in range(VIEWS):
            write_synthetic_view(directory, i, views.camera_rot[i],
                                 views.camera_trans[i], PG_FOVY,
                                 (HEIGHT, WIDTH), semantic=sil[i],
                                 depth_linear=depth[i])
        t2 = time.perf_counter()
        back = [import_synthetic_view(directory, i, rgb=False,
                                      depth_linear=True, semantic=True,
                                      device=dev) for i in range(VIEWS)]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        t['render'] += (t1 - t0) * 1e3
        t['write'] += (t2 - t1) * 1e3
        t['read'] += (t3 - t2) * 1e3
        md = [b['metadata'] for b in back]
        cams = M.CameraViews(
            torch.stack([x['cam_transform'][:3] for x in md]),
            torch.stack([x['cam_transform'][3] for x in md]),
            md[0]['cam_proj'])
        sil_b = torch.stack([b['semantic'] for b in back])
        depth_b = torch.stack([b['depth_linear'] for b in back])
        proj_err = ((cams.camera_proj - views.camera_proj).abs().max()
                    / views.camera_proj.abs().max()).item()
        ok = (torch.equal(cams.camera_rot, views.camera_rot)
              and torch.equal(cams.camera_trans, views.camera_trans)
              and proj_err <= PG_PROJ_RTOL and torch.equal(sil_b, sil)
              and torch.equal(depth_b, depth)
              and sil_b.device.type == torch.device(dev).type)
        _check(ok, f'path G: model {j} views and cameras read back')
        if first is None:
            first = (cams, sil_b, depth_b)
            print(f'path G views: model 0 covers {sil.float().mean():.4f} '
                  f'of {VIEWS} x {HEIGHT}^2 pixels, depth '
                  f'{depth[sil > 0].min():.4f}..{depth.max():.4f}; cam_proj '
                  f'from the metadata rel err {proj_err:.2e} (limit '
                  f'{PG_PROJ_RTOL:g}), rotation and translation bit-equal')
    n = len(models) * VIEWS
    print(f'path G synthetic views: {n} views of {HEIGHT}^2 (semantic, '
          f'depth_linear, metadata): render {t["render"]:.1f} ms, write '
          f'{t["write"]:.1f} ms, import_synthetic_view onto the card '
          f'{t["read"]:.1f} ms (host clock, all {len(models)} models)')
    return first, t


def pg_start(dev):
    s = uv_sphere(*SPHERE)
    return (torch.as_tensor(s.vertices * PG_FIT_RADIUS, device=dev),
            torch.as_tensor(s.faces, device=dev))


def pg_step0(model, dev):
    """Step 0 at 128^2 and one view on the card against the CPU."""
    H = STEP0_SIZE['height']
    views = M.make_views(STEP0_SIZE['views'], fovy=PG_FOVY, device=dev)
    sil, depth = pg_targets(model['vertices'], views, model['faces'], H)
    v0, faces = pg_start(dev)
    out = {}
    for where in (dev, 'cpu'):
        v = v0.detach().to(where).clone().requires_grad_()
        cams = M.CameraViews(*(x.to(where) for x in views))
        loss = pg_loss(v, cams, faces.to(where), sil.to(where),
                       depth.to(where), H)
        loss.backward()
        out[str(where)] = (loss.item(), v.grad.cpu())
    (l_d, g_d), (l_c, g_c) = out[str(dev)], out['cpu']
    rel = abs(l_d - l_c) / abs(l_c)
    scale = g_c.abs().max().item()
    err = (g_d - g_c).abs().max().item()
    print(f'path G step 0 ({H}^2, 1 view), card vs CPU: loss {l_d:.7f} vs '
          f'{l_c:.7f} (rel {rel:.2e}, limit {STEP0_LOSS_RTOL:g}); vertex '
          f'grad max|d| {err:.3e} of {scale:.3e} (limit {STEP0_GRAD_REL:g})')
    _check(rel <= STEP0_LOSS_RTOL, 'path G: step-0 loss card vs CPU')
    _check(scale > 0 and err <= STEP0_GRAD_REL * scale,
           'path G: step-0 gradient card vs CPU')


def pg_fit(views, faces, sil, depth, v0, tl):
    """PG_STEPS Adam steps from the sphere; the mesh and a point cloud
    logged every PG_LOG_EVERY; step 0's kernel launches kept."""
    v = v0.clone().requires_grad_()
    opt = torch.optim.Adam([v], lr=LR)
    gen = torch.Generator(device=v.device).manual_seed(PG_SEED)
    losses, logged = [], {}
    for step in range(PG_STEPS):
        if step % PG_LOG_EVERY == 0:
            cur = v.detach()
            pts = sample_points(cur[None], faces, PG_POINTS,
                                generator=gen)[0][0]
            tl.add_mesh_batch(iteration=step, category='fit',
                              vertices_list=[cur], faces_list=[faces])
            tl.add_pointcloud_batch(iteration=step, category='fit',
                                    pointcloud_list=[pts])
            logged[step] = (cur.cpu().numpy().copy(), pts.cpu().numpy())
        opt.zero_grad()
        with (kept_launches() if step == 0
              else contextlib.nullcontext()) as kept:
            loss = pg_loss(v, views, faces, sil, depth, HEIGHT)
            loss.backward()
        if step == 0:
            first = kept
        opt.step()
        losses.append(loss.item())
    return v.detach(), losses, logged, first


def pg_dash3d(logdir, logged, faces):
    """StreamingGeometryHelper over the fit's Timelapse: the summary and
    every message, decoded, bit-equal to what was logged."""
    helper = StreamingGeometryHelper(logdir)
    summary = helper.summary()
    stamps = [float(s) for s in sorted(logged)]
    listed = {k: [(b['category'], b['id'], b['timestamps']) for b in v]
              for k, v in summary.items()}
    _check(listed == {k: [('fit', 0, stamps)] for k in ('mesh',
                                                        'pointcloud')},
           'path G: dash3d summary lists the mesh and the point cloud')
    nbytes, t0, ok = 0, time.perf_counter(), True
    faces_np = faces.cpu().numpy()
    for step, (verts, pts) in logged.items():
        mesh_msg = helper.get_mesh_message('fit', 0, time=step)
        pc_msg = helper.get_pointcloud_message('fit', 0, time=step)
        nbytes += len(mesh_msg) + len(pc_msg)
        typ_m, (mv, mf) = deserialize_arrays(mesh_msg)
        typ_p, (pp,) = deserialize_arrays(pc_msg)
        ok &= (typ_m == 1 and typ_p == 2
               and mv.tobytes() == verts.astype(np.float32).tobytes()
               and np.array_equal(mf, faces_np.astype(np.uint32))
               and pp.tobytes() == pts.astype(np.float32).tobytes())
    ms = (time.perf_counter() - t0) * 1e3
    print(f'path G dash3d: summary {listed}; {2 * len(logged)} messages, '
          f'{nbytes} bytes in {ms:.1f} ms (host clock: USD read + encode); '
          f'decoded bit-equal to the logged arrays: {ok}')
    _check(ok, 'path G: dash3d messages bit-equal')
    return nbytes, ms


# the kernels' CUDA wrappers by LAUNCHES key: (module, attribute, plain)
HELD = {'fwd': (FU, '_fused_forward_cuda', FU._fused_forward_torch),
        'bwd': (FU, '_fused_backward_cuda', FU._fused_backward_torch),
        'trace': (_trace, '_trace_cuda', _trace._trace_torch),
        'sample': (SA, '_bilinear_forward_cuda', SA._bilinear_forward_torch),
        'sample_bwd': (SA, '_bilinear_backward_cuda',
                       SA._bilinear_backward_torch),
        'scatter': (SC, '_scatter_rows_cuda', SC._scatter_rows_torch),
        'cull': (RS, '_cull_candidates_cuda', RS._cull_candidates_torch)}
EPILOGUE = ('sample', 'sample_bwd', 'scatter')      # E1, E2, E3
DIBR_KERNELS = ('fwd', 'bwd') + EPILOGUE
# the shading's forward and backward (render/mesh/_shade.py): held against
# their plain version by phase 3's check_shade, not by the recorder
SHADE = ('shade', 'shade_bwd')
# render_loss on the card: K1, K2, E2 and E3 (E1's taps are in the
# shading's kernel), the shading
STEP_EPILOGUE = ('sample_bwd', 'scatter')
STEP_KERNELS = ('fwd', 'bwd') + STEP_EPILOGUE + SHADE
# each LAUNCHES key's count dictionary
COUNTS = {k: getattr(mod, 'LAUNCHES') for k, (mod, _, _) in HELD.items()}
COUNTS.update({k: SH.LAUNCHES for k in SHADE})


def zero_launches(keys=tuple(COUNTS)):
    """Set the launch counts of ``keys`` to 0."""
    for k in keys:
        COUNTS[k][k] = 0


def read_launches(keys=DIBR_KERNELS + SHADE):
    """The launch counts of ``keys``."""
    return {k: COUNTS[k][k] for k in keys}


def _clone(x):
    if isinstance(x, tuple):
        return tuple(_clone(y) for y in x)
    return x.clone() if torch.is_tensor(x) else x


@contextlib.contextmanager
def kept_launches(keys=tuple(HELD)):
    """Within the block, keep the inputs and the outputs of every launch
    of the kernels ``keys`` (by LAUNCHES key; all: K1, K2, K3, E1-E3 and
    C1), for :func:`hold_against_plain`: (args, kwargs, outputs,
    captured).  A launch captured in a CUDA graph (``captured`` True) is
    kept by copies captured with it, so after each replay they hold that
    replay's inputs and outputs.  The launches
    themselves, and their counts, are the caller's."""
    kept = {k: [] for k in HELD}
    launch = {k: getattr(*HELD[k][:2]) for k in keys}

    def keeping(key):
        def run(*args, **kw):
            inputs = (_clone(args), {k: _clone(v) for k, v in kw.items()})
            out = launch[key](*args, **kw)
            kept[key].append((*inputs, _clone(out),
                              torch.cuda.is_current_stream_capturing()))
            return out
        return run

    for key in keys:
        setattr(*HELD[key][:2], keeping(key))
    try:
        yield kept
    finally:
        for key in keys:
            setattr(*HELD[key][:2], launch[key])


def _epilogue_err(key, out_k, out_p):
    """max |kernel - plain| of an E1-E3 launch, checked against E1_MAX
    (E1) or E_REL_MAX times each output's largest (E2, E3)."""
    outs = (zip(out_k, out_p) if isinstance(out_k, tuple)
            else [(out_k, out_p)])
    worst = 0.
    for a, b in outs:
        d = (a - b).abs().max().item() if a.numel() else 0.
        scale = b.abs().max().item() if b.numel() else 0.
        limit = (E1_MAX * max(1., scale) if key == 'sample'
                 else E_REL_MAX * scale)
        _check(d <= limit and bool(torch.isfinite(a).all()),
               f'{key} against plain (max|d| {d:.3e}, limit {limit:.3e})')
        worst = max(worst, d)
    return worst


def _epilogue_only(kept):
    """The kept launches of E1-E3 alone (K1 and K2 of a full-size step
    are held on one view, where their plain versions take seconds)."""
    return {k: (v if k in EPILOGUE else []) for k, v in kept.items()}


def hold_against_plain(kept, what):
    """Each kept launch against its kernel's plain version on the same
    inputs, with phases 2-3 and 7's limits: K1 face ids (share differing)
    and prod, K2 the gradient relative to its largest, K3 every output
    bitwise; E1 within E1_MAX, E2 (dT, dx, dy) and E3 within E_REL_MAX of
    each output's largest; C1 (n_b, blk_ids, sat) bit for bit.  Returns
    ({key: launches held}, {key: max abs error})."""
    err = {k: 0. for k in HELD}
    for args, kw, (fid_k, prod_k), _ in kept['fwd']:
        fid_p, prod_p = HELD['fwd'][2](*args, **kw)
        mismatch = (fid_k != fid_p).float().mean().item()
        dprod = (prod_k - prod_p).abs().max().item()
        _check(mismatch <= K1_FID_MISMATCH_MAX and dprod <= K1_PROD_MAX,
               f'{what}: K1 against plain (face ids {mismatch:.3e}, '
               f'prod {dprod:.3e})')
        err['fwd'] = max(err['fwd'], dprod)
    for args, kw, out_k, _ in kept['bwd']:
        out_p = HELD['bwd'][2](*args, **kw)
        d = (out_k - out_p).abs().max().item()
        _check(d <= K2_REL_MAX * out_p.abs().max().item(),
               f'{what}: K2 against plain (max|d| {d:.3e})')
        err['bwd'] = max(err['bwd'], d)
    for args, kw, out_k, _ in kept['trace']:
        out_p = HELD['trace'][2](*args, **kw)
        _check(_same_outputs(out_k, out_p), f'{what}: K3 against plain')
        err['trace'] = max(err['trace'], _max_t_err(out_k, out_p))
    for key in EPILOGUE:
        for args, kw, out_k, _ in kept[key]:
            out_p = HELD[key][2](*args, **kw)
            err[key] = max(err[key], _epilogue_err(key, out_k, out_p))
    for args, kw, out_k, _ in kept['cull']:
        out_p = HELD['cull'][2](*args, **kw)
        d = max((a.long() - b.long()).abs().max().item() if a.numel() else 0
                for a, b in zip(out_k, out_p))
        same_types = all(a.dtype == b.dtype for a, b in zip(out_k, out_p))
        _check(d == 0 and same_types,
               f'{what}: C1 against plain (n_b, blk_ids, sat max|d| {d})')
        err['cull'] = max(err['cull'], d)
    return {k: len(v) for k, v in kept.items()}, err


def pg_frame_render(vertices, faces, size):
    """``render(camera)`` for the visualizers: the mesh through K1
    (``rasterize(backend='fused')``), shaded by |normal . view z|."""
    def render(camera):
        vc = camera.extrinsics.transform(vertices[None])
        vn = camera.intrinsics.transform(vc)
        fvc = index_vertices_by_faces(vc, faces)
        fvi = index_vertices_by_faces(vn[..., :2], faces)
        fn = face_normals(fvc, unit=True)[:, :, None].expand(-1, -1, 3, -1)
        img, fid = rasterize(size, size, fvc[..., -1], fvi, fn,
                             backend='fused')
        return torch.where((fid >= 0)[..., None], img[..., 2:].abs()
                           .expand(-1, -1, -1, 3), 0.)
    return render


def pg_viewers(vertices, faces, dev):
    """Turntable: PG_EVENTS rotate / zoom events, a frame after each;
    first person: move and look, a frame after each.  Frames differ
    between poses; K1 ran once per frame; the first frame's K1 launch is
    held against plain.  Returns K1's max |dprod| there."""
    def cam():
        return Camera.from_args(**{k: torch.tensor(v, dtype=torch.float32,
                                                   device=dev)
                                   if k != 'fov' else v
                                   for k, v in PG_VIEWER.items()},
                                width=WIDTH, height=HEIGHT)
    render = pg_frame_render(vertices, faces, HEIGHT)
    turn = IpyTurntableVisualizer(HEIGHT, WIDTH, cam(), render, max_fps=None)
    first = IpyFirstPersonVisualizer(HEIGHT, WIDTH, cam(), render,
                                     max_fps=None)
    # drags of a few percent of the canvas: a few degrees each
    events = [lambda i=i: (turn.rotate(0.08 * WIDTH * (i + 1), 0.02 * HEIGHT
                                       * i) if i % 2 == 0
                           else turn.zoom(2000.)) for i in range(PG_EVENTS)]
    events += [lambda: first.move_forward(0.2), lambda: first.move_right(),
               lambda: first.move_up(),
               lambda: first.look(0.05 * WIDTH, 0.03 * HEIGHT)]
    before = FU.LAUNCHES['fwd']
    frames, t_ms = [], []
    torch.cuda.synchronize()
    for i, event in enumerate(events):
        event()
        viz = turn if i < PG_EVENTS else first
        with kept_launches() if i == 0 else contextlib.nullcontext() as kept:
            t0 = time.perf_counter()
            frames.append(viz._draw(viz.render))
            t_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:      # the first frame's K1 launch against plain
            held, err = hold_against_plain(kept, 'path G viewer frame')
    k1 = FU.LAUNCHES['fwd'] - before
    differ = all(not np.array_equal(a, b) for a, b in zip(frames, frames[1:]))
    shapes = {f.shape for f in frames}
    print(f'path G viewers: {len(frames)} frames at {HEIGHT}^2 ({PG_EVENTS} '
          f'turntable rotate / zoom events, 4 first-person moves), uint8 '
          f'{shapes}, consecutive frames differ: {differ}; K1 launches '
          f'{k1}; the first frame\'s K1 launch against plain: face ids '
          f'equal within {K1_FID_MISMATCH_MAX:g}, max|dprod| '
          f'{err["fwd"]:.3e}; frame ms (host clock, K1 + copy to the host, '
          f'the first under the recorder) first {t_ms[0]:.1f}, then mean '
          f'{np.mean(t_ms[1:]):.1f}')
    _check(held['fwd'] == 1, 'path G: one viewer frame held against plain')
    _check(shapes == {(HEIGHT, WIDTH, 3)}, 'path G: frame shape')
    _check(differ, 'path G: frames differ between poses')
    _check(k1 == len(frames), 'path G: K1 once per frame')
    _check(all((f > 0).any() for f in frames), 'path G: the mesh in view')
    return err['fwd']


def pg_examples(dev, tmp):
    """The five examples' main() in-process on the card; K1, K2, K3 and
    E1-E3 launches counted around them, each launch held against its kernel's
    plain version on the inputs the example gave it (a launch in the DIB-R
    example's CUDA graph on its last replay's).  Returns (launches, max
    abs errors)."""
    zero_launches()
    err = {k: 0. for k in HELD}
    n_held = {k: 0 for k in HELD}
    n_captured = {k: 0 for k in HELD}
    for name, argv, last in PG_EXAMPLES:
        mod = importlib.import_module(f'kaolin_tpu_torch.examples.{name}')
        extra = (['--logdir', os.path.join(tmp, 'example_timelapse')]
                 if name == 'dibr_inverse_rendering' else [])
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), kept_launches() as kept:
            result = mod.main(argv + extra + ['--device', str(dev)])
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        held, e = hold_against_plain(kept, f'path G example {name}')
        err = {k: max(err[k], e[k]) for k in err}
        n_held = {k: n_held[k] + held[k] for k in n_held}
        n_captured = {k: n_captured[k] + sum(e[3] for e in kept[k])
                      for k in n_captured}
        text = out.getvalue()
        _check(last in text and result.device.type == torch.device(dev).type
               and bool(torch.isfinite(result.float()).all()),
               f'path G: example {name}')
        print(f'path G example {name} {" ".join(argv)}: last line '
              f'{text.strip().splitlines()[-1]!r}; launches held against '
              f'plain on their own inputs {held}, max abs err '
              f'{ {k: float(f"{v:.3e}") for k, v in e.items()} }; '
              f'{secs:.2f} s wall (host clock, test sizes: start-up and '
              f'first calls, with the recorder; not a rate)')
    launches = read_launches(tuple(COUNTS))
    # launches no recorder saw: the replays of captured launches
    replayed = {k: launches[k] - (n_held[k] - n_captured[k])
                for k in HELD}
    print(f'path G examples: kernel launches {launches}, of them replayed '
          f'from CUDA graphs {replayed}; every eager launch held against '
          f'plain, and each of the {n_captured} captured ones on its last '
          f'replay\'s inputs; max abs err {err}')
    _check(all(launches[k] > 0 for k in HELD),
           'path G: the examples launch K1, K2, K3 and E1-E3')
    _check(all(replayed[k] >= n_captured[k]
               and (replayed[k] > 0) == (n_captured[k] > 0)
               for k in HELD),
           'path G: every example launch held, eagerly or on its graph')
    return launches, err


def path_g(dev, card):
    """Phase 23: path G, a ShapeNetV2-layout corpus through CachedDataset
    and a DataLoader, fitted from its own synthetic views through K1 and
    K2, shown in dash3d and the visualizers; then the examples."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        shapenet, modelnet, shrec = pg_corpus(tmp)
        zero_launches()
        models = pg_load(tmp, shapenet, modelnet, shrec, dev)
        (views, sil, depth), t_views = pg_views(models, dev, tmp)
        target = models[0]
        pg_step0(target, dev)
        v0, faces = pg_start(dev)
        _check(torch.equal(faces, target['faces']),
               'path G: the fit shares the models\' faces')
        # K1 and K2 against their plain versions on the first step's
        # inputs, one view (not counted as path launches)
        scene = dict(height=HEIGHT, views=views, faces=faces,
                     params=M.InverseRenderParams(v0, None, None))
        vt, tr, ctr, cbb = kernel_inputs(scene)
        one = tuple(x[:1].contiguous() for x in (vt, tr, ctr, cbb))
        saved = dict(FU.LAUNCHES)
        fid, prod, k1_err = check_forward(scene, one)
        _, k2_err = check_backward(scene, one, fid, prod)
        FU.LAUNCHES.update(saved)
        del vt, tr, ctr, cbb, one, fid, prod
        logdir = os.path.join(tmp, 'timelapse')
        tl = Timelapse(logdir)
        result = {}

        def fit():
            result['fit'] = pg_fit(views, faces, sil, depth, v0, tl)

        fit_launches = read_launches()
        t0 = time.perf_counter()
        idle = step_profile(fit, card, steps=1)
        fit_ms = (time.perf_counter() - t0) * 1e3
        fitted, losses, logged, first = result['fit']
        fit_launches = {k: n - fit_launches[k]
                        for k, n in read_launches().items()}
        held, fit_err = hold_against_plain(_epilogue_only(first),
                                           'path G fit step 0')
        del first
        print(f'path G fit step 0\'s E3 launch held against plain: {held}, '
              f'max abs err {fit_err["scatter"]:.3e}')
        _check(held['scatter'] == 1 and not held['sample'],
               'path G: the fit\'s step 0 launches E3 once (no texture)')
        print(f'path G fit: {PG_STEPS} Adam steps (fused, {VIEWS} views, '
              f'{HEIGHT}^2) of the radius-{PG_FIT_RADIUS} sphere to model '
              f'0\'s imported silhouettes and depths: loss {losses[0]:.6f} '
              f'-> {losses[-1]:.6f}; K1/K2/E1-E3 launches {fit_launches}; '
              f'{fit_ms:.1f} ms with the Timelapse, under the profiler '
              f'(host clock), card idle share {idle:.3f}')
        _check(losses[-1] < losses[0], 'path G: the loss falls')
        _check(fit_launches['fwd'] >= PG_STEPS
               and fit_launches['bwd'] >= PG_STEPS
               and fit_launches['scatter'] >= PG_STEPS,
               'path G: K1, K2 and E3 on every step')
        step_ms = time_ms(lambda: pg_loss(
            fitted.clone().requires_grad_(), views, faces, sil, depth,
            HEIGHT).backward(), 3)
        nbytes, dash_ms = pg_dash3d(logdir, logged, faces)
        viewer_err = pg_viewers(fitted, faces, dev)
        launches = read_launches()
        ex_launches, ex_err = pg_examples(dev, tmp)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[{card}] path G: fit step {step_ms:.3f} ms (CUDA events, '
          f'forward + backward, {VIEWS} views, {HEIGHT}^2); dash3d '
          f'{nbytes} bytes in {dash_ms:.1f} ms; K1/K2/E1-E3 launches on '
          f'path G '
          f'{launches}, in the examples {ex_launches}; peak device memory '
          f'{peak:.3f} GiB')
    return dict(launches=launches, examples=ex_launches,
                k1_err=max(k1_err, viewer_err, ex_err['fwd']),
                k2_err=max(k2_err, ex_err['bwd']), k3_err=ex_err['trace'],
                cull_err=ex_err['cull'],
                epi_err={k: max(fit_err[k], ex_err[k]) for k in EPILOGUE},
                step_ms=step_ms, idle=idle, peak=peak)


# ---------------------------------------------------------------------------
# Path H: the multi-GPU DIB-R step (parallel/, BASELINE config #5)

PH_CFG5 = dict(height=1024, views=8)    # config #5's per-view width
PH_TILE = dict(height=128, views=2)     # the row-sharded 'jnp' loss
PH_RANKS = 2
PH_TILE_MESHES = ((1, 2), (2, 1))       # (data, tile)
PH_CAP_S = 300.             # hard cap on the spawned ranks, start-up included
# the sharded step against the one-process step on the same card: the same
# kernels and arithmetic on fewer views a call (batched matmuls may take
# another cuBLAS kernel), and sums over the ranks in another order
PH_LOSS_RTOL = 1e-5
PH_GRAD_REL = 1e-4


def ph_scene(height, views, dev, backend='fused'):
    """The DIB-R cell's sphere, texture size and start point as numpy
    arrays, the targets rendered on ``dev``."""
    return DR.make_scene(height, views, TEXTURE_RES, SPHERE, backend, KNUM,
                         device=dev)


def ph_close(what, loss, grads, ref):
    """Loss and gradients against (loss, gradients) of the one-process
    step; returns the largest gradient error relative to its largest."""
    ref_loss, ref_grads = ref
    rel = abs(loss - ref_loss) / abs(ref_loss)
    errs = [float(np.abs(np.asarray(g) - r).max() / np.abs(r).max())
            for g, r in zip(grads, ref_grads)]
    print(f'{what}: loss {loss:.7f} vs {ref_loss:.7f} (rel {rel:.2e}, '
          f'limit {PH_LOSS_RTOL:g}); gradient max|d| / max|g| '
          f'{", ".join(f"{n} {e:.2e}" for n, e in zip(DR.PARAMS, errs))} '
          f'(limit {PH_GRAD_REL:g})')
    _check(rel <= PH_LOSS_RTOL, f'{what}: loss')
    _check(all(e <= PH_GRAD_REL for e in errs), f'{what}: gradients')
    return max(errs)


def ph_world1(dev, card, scene, ref):
    """Part 1: world size 1 on NCCL in this process: ``multi_view_grad``
    over the fused trainer loss at the DIB-R cell's width.  Step 0 against
    the one-process step, its K1 and K2 launches against their plain
    versions; 5 Adam steps (K1 / K2 launches counted around step 0 and
    them); the step and the one-process step in turns; the step's parts
    (forward, backward, all-reduce) inside the same step; its idle
    share."""
    H = HEIGHT
    mesh = D.make_global_mesh(device=dev)
    views = shard_views(mesh, tuple(scene[k] for k in DR.VIEW_FIELDS))
    model = M.InverseRender(*replicate(mesh, DR.start_model(scene, dev)
                                       .as_params()))
    loss_fn = DR.view_loss(scene, H, dev)
    step = multi_view_grad(loss_fn, mesh)
    zero_launches()
    with kept_launches() as kept:
        loss, grads = step(model.as_params(), views)
        torch.cuda.synchronize()
    grad_err = ph_close(
        f'path H step 0, world size 1 (nccl), {VIEWS} views at {H}^2, '
        f'against the one-process step', loss.item(),
        [g.cpu().numpy() for g in grads], ref)
    held, err = hold_against_plain(kept, 'path H step 0')
    _check(all(held[k] >= 1 for k in ('fwd', 'bwd') + STEP_EPILOGUE),
           'path H: K1, K2, E2 and E3 launched in the step')
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    losses = []
    for _ in range(STEPS):
        loss, grads = step(model.as_params(), views)
        for p, g in zip(model.parameters(), grads):
            p.grad = g
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    launches = read_launches()
    print(f'path H: {STEPS} Adam steps through multi_view_grad: loss '
          f'{" -> ".join(f"{x:.6f}" for x in losses)}; K1/K2/E1-E3/shading '
          f'launches {launches} (step 0 and the {STEPS} steps); step 0\'s '
          f'launches held against plain {held}, max abs err K1 prod '
          f'{err["fwd"]:.3e}, K2 {err["bwd"]:.3e}, E2, E3 '
          f'{ {k: float(f"{err[k]:.3e}") for k in STEP_EPILOGUE} }')
    _check(losses[-1] < losses[0], 'path H: the loss falls')
    _check(all(launches[k] >= STEPS + 1 for k in STEP_KERNELS),
           'path H: K1, K2, E2, E3 and the shading on every step')

    params = model.as_params()
    everything = tuple(torch.as_tensor(scene[k], device=dev)
                       for k in DR.VIEW_FIELDS)
    sharded_ms, one_ms = measure.in_turns(
        time_ms, lambda: step(params, views),
        lambda: torch.autograd.grad(loss_fn(params, everything),
                                    list(params)), 5)

    def parts_step(mark):
        def forward(p, v):
            out = loss_fn(p, v)
            mark()
            return out

        def all_reduce(t, axis=None):
            mark()
            return type(mesh).all_reduce(mesh, t, axis)

        mesh.all_reduce = all_reduce
        try:
            multi_view_grad(forward, mesh)(params, views)
        finally:
            del mesh.all_reduce
        mark()

    names = ('forward', 'backward', 'all-reduce')
    parts, steps = step_parts_ms(parts_step)
    line = check_parts('path H step', names, parts, steps)
    idle = step_profile(lambda: step(params, views), card)
    print(f'[{card}] path H, world size 1 (nccl): step {sharded_ms:.3f} ms '
          f'= {VIEWS * H * H / sharded_ms / 1e3:.3f} Mpix/s, the '
          f'one-process step {one_ms:.3f} ms (in turns); parts: {line}; '
          f'idle share {idle:.3f}')
    return dict(launches=launches, k1_err=err['fwd'], k2_err=err['bwd'],
                epi_err={k: err[k] for k in EPILOGUE}, grad_err=grad_err,
                step_ms=sharded_ms, one_ms=one_ms,
                parts=dict(zip(names, parts.mean(0).tolist())), idle=idle,
                losses=losses)


def ph_config5(dev, card):
    """Part 2: config #5's per-view width at world size 1: 1024^2, 8
    views, fused.  K1 and K2 against their plain versions on the first
    step's inputs, one view (the plain versions take seconds a view at
    1024^2); the step's time, views/s and peak memory."""
    H, B = PH_CFG5['height'], PH_CFG5['views']
    scene = ph_scene(H, B, dev)
    mesh = D.make_global_mesh(device=dev)
    views = shard_views(mesh, tuple(scene[k] for k in DR.VIEW_FIELDS))
    model = DR.start_model(scene, dev)
    cams = M.CameraViews(views[0], views[1],
                         torch.as_tensor(scene['camera_proj'], device=dev))
    vt, tr, ctr, cbb = kernel_inputs(dict(
        height=H, views=cams, faces=torch.as_tensor(scene['faces'],
                                                   device=dev),
        params=model.as_params()))
    one = tuple(x[:1].contiguous() for x in (vt, tr, ctr, cbb))
    saved = dict(FU.LAUNCHES)
    fid, prod, k1_err = check_forward(dict(height=H), one)
    _, k2_err = check_backward(dict(height=H), one, fid, prod)
    FU.LAUNCHES.update(saved)
    del vt, tr, ctr, cbb, one, fid, prod
    print(f'path H config #5 width: K1 and K2 held against plain on the '
          f'first step\'s inputs, 1 of the {B} views (the plain versions '
          f'run seconds a view at {H}^2)')
    step = multi_view_grad(DR.view_loss(scene, H, dev), mesh)
    params = model.as_params()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = step(params, views)
    _check(bool(torch.isfinite(loss)), 'path H config #5 width: loss finite')
    ms = time_ms(lambda: step(params, views), 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[{card}] path H, config #5 per-view width (world size 1, nccl, '
          f'{B} views at {H}^2, fused): step {ms:.3f} ms = '
          f'{B / ms * 1e3:.2f} views/s = {B * H * H / ms / 1e3:.3f} Mpix/s; '
          f'peak device memory {peak:.3f} GiB')
    return dict(step_ms=ms, views_per_s=B / ms * 1e3, peak_gib=peak,
                k1_err=k1_err, k2_err=k2_err)


def ph_world2(dev, card, scene, ref):
    """Part 3: world size 2 on gloo, both ranks on this card, spawned by
    ``parallel/dryrun.py::run`` under its hard cap: the sharded fused step
    (2 views a rank, against the one-process 4-view step), then the
    row-sharded 'jnp' loss on (1 x 2) and (2 x 1) meshes and the sharded
    selection on (1 x 2), at 128^2, 2 views, against the one-process
    'jnp' loss and selection on this card.  NCCL refuses two ranks on one
    device, hence gloo (which takes CUDA tensors in all_reduce and
    broadcast)."""
    H, B = PH_TILE['height'], PH_TILE['views']
    tile_scene = ph_scene(H, B, dev, backend='jnp')
    t0 = time.perf_counter()
    ranks = DR.run(PH_RANKS, [
        (DR.sharded_step, dict(scene=scene, height=HEIGHT)),
        (DR.tile_checks, dict(scene=tile_scene, height=H, knum=KNUM,
                              meshes=PH_TILE_MESHES,
                              selection_mesh=PH_TILE_MESHES[0]))],
        timeout=PH_CAP_S, dist_backend='gloo', device=dev)
    secs = time.perf_counter() - t0
    steps = [r[0] for r in ranks]
    for s in steps[1:]:
        _check(s['loss'] == steps[0]['loss'] and all(
            np.array_equal(a, b) for a, b in zip(s['grads'],
                                                 steps[0]['grads'])),
            'path H world size 2: loss and gradients equal on the ranks')
    _check(all(s['launches']['fwd'] >= 1 and s['launches']['bwd'] >= 1
               and all(s['moved']) for s in steps),
           'path H world size 2: K1 and K2 on every rank, Adam moved')
    step_err = ph_close(
        f'path H world size 2 (gloo, 2 ranks on one card), {VIEWS // 2} '
        f'views a rank, against the one-process {VIEWS}-view step',
        steps[0]['loss'], steps[0]['grads'], ref)

    tile_ref = DR.one_process_step(tile_scene, H, backend='jnp', knum=KNUM,
                                   device=dev)
    model = DR.start_model(tile_scene, dev)
    cams = M.CameraViews(*(torch.as_tensor(tile_scene[k], device=dev)
                           for k in ('camera_rot', 'camera_trans',
                                     'camera_proj')))
    faces = torch.as_tensor(tile_scene['faces'], device=dev)
    with torch.no_grad():
        fvc, fvi, fn = M._prepare(model, cams, faces)
        sel_ref = rasterize_selection(H, H, fvc[..., 2], fvi,
                                      valid_faces=fn[..., 2] >= 0.,
                                      backend='jnp').cpu().numpy()
    tile_err = 0.
    for shape in PH_TILE_MESHES:
        got = [r[1]['loss'][shape] for r in ranks]
        _check(all(g[0] == got[0][0] and all(
            np.array_equal(a, b) for a, b in zip(g[1], got[0][1]))
            for g in got), f'path H tile {shape}: equal on the ranks')
        tile_err = max(tile_err, ph_close(
            f'path H tile_sharded_render_loss on a {shape} (data x tile) '
            f'mesh, {B} views at {H}^2, against the one-process '
            f'render_loss(backend=\'jnp\')', got[0][0], got[0][1], tile_ref))
    same = all(np.array_equal(r[1]['selection'], sel_ref) for r in ranks)
    print(f'path H tile_sharded_selection on {PH_TILE_MESHES[0]}: equal to '
          f'rasterize_selection(backend=\'jnp\') on every rank: {same}')
    _check(same, 'path H: the row-sharded selection')
    print(f'[{card}] path H, world size {PH_RANKS} (gloo, both ranks on '
          f'cuda:0): the spawn and both jobs {secs:.2f} s (host clock, cap '
          f'{PH_CAP_S:g} s; start-up included); K1/K2 launches per rank '
          f'{[s["launches"] for s in steps]}')
    return dict(seconds=secs, launches=[s['launches'] for s in steps],
                grad_err=step_err, tile_grad_err=tile_err,
                loss=steps[0]['loss'], gnorm=steps[0]['gnorm'])


def path_h(dev, card):
    """Phase 24: path H, the multi-GPU DIB-R step of BASELINE config #5
    through ``kaolin_tpu_torch.parallel``: world size 1 on NCCL in this
    process (the DIB-R cell, then config #5's per-view width), then world
    size 2 on gloo in two spawned ranks on this card.  Prints the
    ``parallel`` line."""
    scene = ph_scene(HEIGHT, VIEWS, dev)
    ref = DR.one_process_step(scene, HEIGHT, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        D.initialize('file://' + os.path.join(tmp, 'store'), 1, 0,
                     backend='nccl')
        try:
            one = ph_world1(dev, card, scene, ref)
            torch.cuda.empty_cache()
            cfg5 = ph_config5(dev, card)
        finally:
            torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    two = ph_world2(dev, card, scene, ref)
    print(json.dumps({'parallel': dict(
        card=card,
        world_size_1=dict(backend='nccl', views=VIEWS, height=HEIGHT,
                          **{k: one[k] for k in ('step_ms', 'one_ms',
                                                 'parts', 'idle')}),
        config5_width=dict(backend='nccl', views=PH_CFG5['views'],
                           height=PH_CFG5['height'],
                           **{k: cfg5[k] for k in ('step_ms', 'views_per_s',
                                                   'peak_gib')}),
        world_size_2=dict(backend='gloo', ranks_on_one_card=PH_RANKS,
                          views_per_rank=VIEWS // PH_RANKS, height=HEIGHT,
                          seconds=two['seconds'],
                          launches=two['launches']))}))
    return dict(launches=one['launches'], epi_err=one['epi_err'],
                k1_err=max(one['k1_err'], cfg5['k1_err']),
                k2_err=max(one['k2_err'], cfg5['k2_err']))


# ---------------------------------------------------------------------------
# DIB-R++ (phase 25): the model of models/dibrpp.py through the compiled step
# at the sg.lights.512x4 cell's size: the DIB-R cell's sphere, views and
# vertex noise, a 4-channel 256^2 material map and path C's 32 lights

PP_ROUGHNESS_GT = (0.2, 0.6)    # the ground truth's roughness, uniform
PP_ROUGHNESS_START = 0.3
PP_SEED = 26


def dibrpp_scene(dev, height=HEIGHT, views=VIEWS, texture_res=TEXTURE_RES):
    """The DIB-R++ fit's inputs at the cell's start point: targets rendered
    by ``models/dibrpp.py::render_views`` from the unperturbed sphere, a
    material map (albedo uniform, roughness uniform in PP_ROUGHNESS_GT)
    and path C's ground-truth lights; the start the vertices perturbed as
    :func:`make_scene` perturbs them, a material map drawn anew with
    roughness PP_ROUGHNESS_START and path C's start lights."""
    s = uv_sphere(*SPHERE)
    faces = torch.as_tensor(s.faces, device=dev)
    face_uvs = torch.as_tensor(s.uvs[s.face_uvs_idx], device=dev)
    cams = M.make_views(views, device=dev)
    v = M.init_params(s, texture_res, device=dev).vertices.detach()
    rng = np.random.default_rng(PP_SEED)
    mat_gt = rng.random((4, texture_res, texture_res), dtype=np.float32)
    lo, hi = PP_ROUGHNESS_GT
    mat_gt[3] = lo + (hi - lo) * mat_gt[3]
    mat0 = rng.random((4, texture_res, texture_res), dtype=np.float32)
    mat0[3] = PP_ROUGHNESS_START
    lights_gt, lights0 = sg_start(dev)
    gt = DP.DIBRPP(v.clone(), torch.as_tensor(mat_gt, device=dev),
                   *(torch.as_tensor(x, device=dev) for x in lights_gt))
    with torch.no_grad():
        sel = M.compute_selection(gt, cams, faces, height, height,
                                  backend='fused')
        target_images, target_masks, _ = DP.render_views(
            gt, cams, faces, face_uvs, height, height, backend='fused',
            selection=sel)
    noise = np.random.default_rng(0).standard_normal(
        tuple(v.shape)).astype(np.float32)
    start = (v + 0.05 * torch.as_tensor(noise, device=dev),
             torch.as_tensor(mat0, device=dev),
             *(x.detach() for x in lights0))
    return dict(faces=faces, face_uvs=face_uvs, views=cams, start=start,
                target_images=target_images, target_masks=target_masks,
                height=height)


def dibrpp(dev, card, steps=STEPS):
    """Phase 25: ``steps`` Adam steps of ``M.compiled_step(...,
    loss_fn=DP.render_loss)`` (one CUDA graph a step, capturable Adam over
    the six leaves) at the cell's size, held against as many eager steps
    from the same start: step 0's loss bit for bit and its gradients within
    REPLAY_GRAD_REL, every loss within step 0's card-vs-CPU limit; K1, K2
    and E1-E3 as launched inside the graph (E1 and E2 over the 4-channel
    material map, E3 over the 30-column face rows of uv, normal and world
    corners) against their plain versions on its last replay's inputs,
    with :func:`hold_against_plain`'s limits; the launches counted per
    replay (one of each of K1, K2, E1-E3, none of the SH shading's
    kernels); the loss falls, every leaf moves; the replay's time and the
    peak memory of the build and the replays.  Returns (the launches over
    the replays, K1, K2 and E1-E3's max abs errors inside the graph)."""
    sc = dibrpp_scene(dev)
    H = sc['height']
    fixed = (sc['views'], sc['faces'], sc['face_uvs'], sc['target_images'],
             sc['target_masks'], H, H)

    def model():
        m = DP.DIBRPP(*(t.clone() for t in sc['start']))
        return m, torch.optim.Adam(m.parameters(), lr=LR, capturable=True)

    twin, opt_e = model()
    eager = []
    for _ in range(steps):
        for p in twin.parameters():
            p.grad = None
        sel = M.compute_selection(twin, sc['views'], sc['faces'], H, H,
                                  backend='fused')
        loss = DP.render_loss(twin, *fixed, backend='fused', selection=sel)
        loss.backward()
        eager.append(dict(loss=loss.detach(), grads=[
            p.grad.clone() for p in twin.parameters()]))
        opt_e.step()
    del twin, opt_e
    params, opt = model()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with kept_launches() as kept:
        step = M.compiled_step(params, *fixed, opt, backend='fused',
                               loss_fn=DP.render_loss)
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    zero_launches()
    out = []
    for _ in range(steps):
        loss = step(sc['views'], sc['target_images'], sc['target_masks'])
        out.append(dict(loss=loss, grads=[p.grad.clone()
                                          for p in params.parameters()]))
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [o['loss'].item() for o in out]
    for k, (o, e) in enumerate(zip(out, eager)):
        rel = abs(losses[k] - e['loss'].item()) / abs(e['loss'].item())
        print(f'DIB-R++ step {k}: loss {losses[k]:.7f}, eager '
              f'{e["loss"].item():.7f} (rel {rel:.2e}, limit '
              f'{STEP0_LOSS_RTOL:g})')
        _check(rel <= STEP0_LOSS_RTOL, f'DIB-R++ step {k} loss against '
               'eager')
    o, e = out[0], eager[0]
    g_rel = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
             for a, b in zip(o['grads'], e['grads'])]
    same = torch.equal(_bits(o['loss']), _bits(e['loss']))
    print(f'DIB-R++ step 0, replay against eager from the same parameters: '
          f'loss bit-equal {same}; gradients max|d| / max|g| (vertices, '
          f'material, amplitude, azimuth, elevation, sharpness) '
          + ', '.join(f'{x:.2e}' for x in g_rel)
          + f' (limit {REPLAY_GRAD_REL["fused"]:g})')
    _check(same, 'DIB-R++ step 0: the replay\'s loss bit-equal to eager')
    _check(all(x <= REPLAY_GRAD_REL['fused'] for x in g_rel),
           'DIB-R++ step 0: the replay\'s gradients against eager')
    in_graph = {k: [e for e in v if e[3]] for k, v in kept.items()}
    held, err = hold_against_plain(in_graph, 'DIB-R++: K1/K2/E1-E3 inside '
                                   'the graph')
    print(f'DIB-R++: K1/K2/E1-E3 as launched inside the graph, on its last '
          f'replay\'s inputs, against plain: {held} held, max abs err {err}')
    _check(held['fwd'] == held['bwd'] == 1 and not held['trace']
           and not held['cull'] and all(held[k] == 1 for k in EPILOGUE),
           'DIB-R++: the graph holds one launch of each of K1, K2, E1-E3')
    print('DIB-R++: E1-E3\'s tensor inputs in the graph ' + str(
        {k: [tuple(a.shape) for a in in_graph[k][0][0] if torch.is_tensor(a)]
         for k in EPILOGUE}))
    print(f'DIB-R++ kernel launches during the {steps} replays: {launches}')
    _check(launches == dict(fwd=steps, bwd=steps, sample=steps,
                            sample_bwd=steps, scatter=steps, shade=0,
                            shade_bwd=0),
           'DIB-R++: one launch of each of K1, K2, E1-E3 counted per '
           'replay, none of the SH shading\'s kernels')
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           'DIB-R++: the loss falls')
    for (n, p), s0 in zip(params.named_parameters(), sc['start']):
        _check(bool(torch.isfinite(p).all()) and not torch.equal(
            p.detach(), s0), f'DIB-R++: {n} finite and moved')

    def call():
        return step(sc['views'], sc['target_images'], sc['target_masks'])
    ms = time_ms(call, 5)
    B = sc['views'].camera_rot.shape[0]
    print(f'[{card}] DIB-R++ compiled step ({B} views, {H}x{H}, '
          f'{sc["faces"].shape[0]} faces, {DP.LOBES} SG lights): built in '
          f'{build_s:.2f} s, {ms:.3f} ms a step = '
          f'{B * H * H / ms / 1e3:.3f} Mpix/s; peak allocated over build and '
          f'replays {peak / 2 ** 30:.3f} GiB')
    return launches, {k: err[k] for k in ('fwd', 'bwd') + EPILOGUE}


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py: torch.cuda.is_available() is '
                         'False; this script runs only on a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    card = measure.card()
    start = last = time.perf_counter()

    def phase(name):
        nonlocal last
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f'-- phase {name}: {now - last:.1f} s')
        last = now

    toolchain(card)
    phase('1: toolchain and kernel builds')
    scene = make_scene(dev)
    torch.cuda.synchronize()
    inputs = kernel_inputs(scene)
    fid, prod, k1_err = check_forward(scene, inputs)
    phase('2: K1 against plain')
    g_prod, k2_err = check_backward(scene, inputs, fid, prod)
    culling(scene, inputs, g_prod)
    epi, step_bits = check_epilogue(scene, card)
    shade_rows = check_shade(scene, card)
    phase('3: K2 against plain, culling; E1-E3 and the shading against '
          'plain, their times')
    launches, _, call, peak, epi_err = train(scene)
    check_step_against_plain(make_scene(dev, **STEP0_SIZE))
    phase('4: 5 Adam steps of the compiled step against eager, step 0 '
          f'against the CPU at {STEP0_SIZE["height"]}^2')
    t = times(scene, inputs, g_prod, card, call, peak)
    del call
    phase('5: DIB-R times (eager and compiled in turns) and profiles')

    fv = spc_mesh()
    spc_build(fv, dev)
    phase('6: SPC builds')
    spc = spc_main_path(fv, dev)
    args, k3_err = check_trace_kernel(spc)
    phase('6-7: SPC main path, K3 against plain')
    dense_err, dense_args = check_dense(dev)
    k3_err = max(k3_err, dense_err)
    phase('8: K3 on the dense octree')
    check_against_bfs(spc)
    phase('9: trace against the BFS')
    ts = spc_times(spc, args, card)
    phase('10: SPC times')

    _check(_probe_counts() == 0, 'no probe kernel ran on the DIB-R and '
           'SPC paths')
    p1, c1 = probe_p1(spc, card)
    phase('11: P1')
    p2, c2 = probe_p2(spc, card)
    phase('12: P2 and the trace by stage')
    p3, c3 = probe_p3(args, dense_args, card)
    phase('13: P3')
    k1_b, k1_f, k2_b, k2_f = dibr_work(scene, inputs, g_prod)
    k3_b, k3_f, _ = kbisect.trace_work(args, spc['hits'].count, False)
    print(f'bounds from this run\'s inputs: K1 {k1_b} bytes, {k1_f} flops; '
          f'K2 {k2_b} bytes, {k2_f} flops ({k2_f // K2_FLOPS} (face, pixel) '
          f'pairs); K3 {k3_b} bytes, {k3_f} flops')
    spc_launches = spc['launches']
    c1_launches, c1_err = spc['cull_launches'], spc['cull_err']
    del spc, dense_args, scene, inputs, g_prod, fid, prod, args
    torch.cuda.empty_cache()

    zero_launches()
    cfg1 = config1(dev, card)
    phase('14: config #1 (OBJ -> k-buffer DIB-R 256^2)')
    deftet(dev, card)
    phase('15: config #4 (DefTet 256^2)')
    tetmesh(dev, card)
    phase('16: tetmesh ops and losses')
    path_a_out = path_a(fv, dev, card)
    phase('17: path A (camera -> K3 -> trilinear features -> integration)')
    path_b(fv, dev, card)
    phase('18: path B (sparse convolutions over the level-10 octree)')
    torch.cuda.empty_cache()
    path_c_out = path_c(dev, card)
    phase('19: path C (SG light recovery through K1)')
    torch.cuda.empty_cache()
    path_d(dev, card)
    phase('20: path D (DMTet chamfer fit)')
    torch.cuda.empty_cache()
    path_e(dev, card)
    phase('21: path E (occupancy evaluation)')
    torch.cuda.empty_cache()
    path_f_out = path_f(dev, card)
    phase('22: path F (DIB-R fit with Timelapse and checkpoint, MISE '
          'through the triangle hash)')
    torch.cuda.empty_cache()
    path_g_out = path_g(dev, card)
    phase('23: path G (datasets -> synthetic views -> DIB-R fit -> dash3d '
          'and the visualizers; the examples)')
    torch.cuda.empty_cache()
    path_h_out = path_h(dev, card)
    phase('24: path H (the DIB-R step sharded over ranks: world size 1 on '
          'nccl, config #5\'s width, world size 2 on gloo)')
    torch.cuda.empty_cache()
    pp_launches, pp_err = dibrpp(dev, card)
    phase('25: DIB-R++ (the compiled step with models/dibrpp.py\'s loss at '
          'the sg.lights.512x4 cell\'s size)')

    src = 'kaolin_tpu_torch/csrc/dibr_fused.cu'
    trace_src = 'kaolin_tpu_torch/csrc/spc_trace.cuh'
    kernels = [
        dict(name='fused_forward_kernel', route='cuda', source=src,
             replaces='kaolin_tpu/render/mesh/_fused.py:232',
             launches=(launches['fwd'] + path_c_out['launches']
                       + path_f_out['launches']['fwd']
                       + path_g_out['launches']['fwd']
                       + path_g_out['examples']['fwd']
                       + path_h_out['launches']['fwd'] + pp_launches['fwd']),
             path_launches={'dibr': launches['fwd'],
                            'path_c': path_c_out['launches'],
                            'path_f': path_f_out['launches']['fwd'],
                            'path_g': path_g_out['launches']['fwd'],
                            'examples': path_g_out['examples']['fwd'],
                            'path_h': path_h_out['launches']['fwd'],
                            'dibrpp': pp_launches['fwd']},
             max_abs_err=max(k1_err, path_c_out['k1_err'],
                             path_f_out['k1_err'], path_g_out['k1_err'],
                             path_h_out['k1_err'], pp_err['fwd']),
             ms=t['k1_ms'], plain_ms=t['k1_plain_ms'],
             **_bound(k1_b, k1_f), library_ms=None,
             path_c_ms=path_c_out['k1_ms'],
             path_c_plain_ms=path_c_out['k1_plain_ms']),
        dict(name='fused_backward_kernel', route='cuda', source=src,
             replaces='kaolin_tpu/render/mesh/_fused.py:386',
             launches=(launches['bwd'] + path_f_out['launches']['bwd']
                       + path_g_out['launches']['bwd']
                       + path_g_out['examples']['bwd']
                       + path_h_out['launches']['bwd'] + pp_launches['bwd']),
             path_launches={'dibr': launches['bwd'],
                            'path_f': path_f_out['launches']['bwd'],
                            'path_g': path_g_out['launches']['bwd'],
                            'examples': path_g_out['examples']['bwd'],
                            'path_h': path_h_out['launches']['bwd'],
                            'dibrpp': pp_launches['bwd']},
             max_abs_err=max(k2_err, path_f_out['k2_err'],
                             path_g_out['k2_err'], path_h_out['k2_err'],
                             pp_err['bwd']),
             ms=t['k2_ms'], plain_ms=t['k2_plain_ms'],
             **_bound(k2_b, k2_f), library_ms=None),
        dict(name='spc_trace_kernel', route='cuda', source=trace_src,
             replaces='kaolin_tpu/render/spc/raster.py:459',
             launches=(spc_launches + path_a_out['launches']
                       + path_g_out['examples']['trace']),
             path_launches={'spc_main': spc_launches,
                            'path_a': path_a_out['launches'],
                            'examples': path_g_out['examples']['trace']},
             max_abs_err=max(k3_err, path_a_out['k3_err'],
                             path_g_out['k3_err']),
             ms=ts['k3_ms'], plain_ms=ts['k3_plain_ms'],
             **_bound(k3_b, k3_f), library_ms=None,
             pinhole_ms=path_a_out['k3_ms'],
             pinhole_exit_ms=path_a_out['k3_exit_ms']),
        dict(name='spc_cull_kernel', route='cuda',
             source='kaolin_tpu_torch/csrc/spc_cull.cu',
             replaces='kaolin_tpu/render/spc/raster.py:710 (jnp, no Pallas '
                      'kernel)',
             launches=(c1_launches + path_a_out['cull_launches']
                       + path_g_out['examples']['cull']),
             path_launches={'spc_main': c1_launches,
                            'path_a': path_a_out['cull_launches'],
                            'examples': path_g_out['examples']['cull']},
             max_abs_err=max(c1_err, path_a_out['cull_err'],
                             path_g_out['cull_err']),
             ms=ts['c1_ms'], plain_ms=ts['c1_plain_ms'], **ts['c1_bound'],
             library_ms=None),
    ]
    # E1-E3: the DIB-R step's epilogue and its backward, on every path
    # that renders through rasterize's epilogue and texture_mapping
    epi_src = 'kaolin_tpu_torch/csrc/epilogue.cu'
    epi_replaces = dict(sample='kaolin_tpu/render/mesh/utils.py:42',
                        sample_bwd='kaolin_tpu/render/mesh/utils.py:66',
                        scatter='kaolin_tpu/ops/gather.py:63')
    epi_names = dict(sample='bilinear_forward_kernel',
                     sample_bwd='bilinear_pixels_kernel+segment_sums',
                     scatter='segment_sums')
    for k in EPILOGUE:
        per_path = {'dibr': launches[k], 'config1': cfg1['launches'][k],
                    'path_f': path_f_out['launches'][k],
                    'path_g': path_g_out['launches'][k],
                    'examples': path_g_out['examples'][k],
                    'path_h': path_h_out['launches'][k],
                    'dibrpp': pp_launches[k]}
        row = dict(epi[k])
        row['max_abs_err'] = max(row['max_abs_err'], epi_err[k], pp_err[k],
                                 *(out['epi_err'][k] for out in (
                                     path_f_out, path_g_out, path_h_out)))
        kernels.append(dict(
            name=epi_names[k], route='cuda', source=epi_src,
            replaces=epi_replaces[k], launches=sum(per_path.values()),
            path_launches=per_path, **row))
    # the shading: render_loss on the card (the DIB-R step, config #1, paths
    # F and H, the DIB-R example)
    for k, name in (('shade', 'shade_forward_kernel+shade_loss_kernel'),
                    ('shade_bwd', 'shade_backward_kernel+shade_sh_kernel')):
        per_path = {'dibr': launches[k], 'config1': cfg1['launches'][k],
                    'path_f': path_f_out['launches'][k],
                    'path_g': path_g_out['launches'][k],
                    'examples': path_g_out['examples'][k],
                    'path_h': path_h_out['launches'][k],
                    'dibrpp': pp_launches[k]}
        kernels.append(dict(
            name=name, route='cuda',
            source='kaolin_tpu_torch/csrc/shade.cuh',
            replaces='kaolin_tpu/models/inverse_render.py:112-170 (XLA\'s '
                     'fusion, no Pallas kernel)',
            launches=sum(per_path.values()), path_launches=per_path,
            library_ms=None, **shade_rows[k]))
    # the probes: `launches` counts their own entry point's run; none ran
    # on the DIB-R or SPC main paths (main_path_launches)
    for name in mosaic3.KERNELS:
        k = p1['script'][name]
        entry = dict(
            name=name, route='cuda',
            source='kaolin_tpu_torch/csrc/probes.cu',
            replaces=f'scripts/probe_r5_mosaic3.py:{P1_LINES[name]}',
            launches=c1[name], main_path_launches=0,
            max_abs_err=p1['max_abs_err'][name], ms=k['ms'],
            plain_ms=k['plain_ms'], bound_ms=k['bound_ms'],
            bound_by=k['bound_by'], library_ms=k['library_ms'],
            device_ms=k['device_ms'],
            library_device_ms=k['library_device_ms'])
        for where in ('staging', 'large'):
            if name in (p1[where] or {}):
                entry[where] = {key: p1[where][name][key] for key in (
                    'ms', 'device_ms', 'plain_ms', 'library_ms',
                    'library_device_ms', 'bound_ms', 'bound_by')}
        kernels.append(entry)
    k = p2['dummy'][max(p2['dummy'])]
    kernels.append(dict(
        name='dummy_kernel', route='cuda',
        source='kaolin_tpu_torch/csrc/probes.cu',
        replaces='scripts/probe_r5_stages.py:166', launches=c2['dummy'],
        main_path_launches=0,
        max_abs_err=max(d['max_abs_err'] for d in p2['dummy'].values()),
        ms=k['ms'], plain_ms=k['plain_ms'], bound_ms=k['bound_ms'],
        bound_by=k['bound_by'], library_ms=k['library_ms'],
        device_ms=k['device_ms'], library_device_ms=k['library_device_ms'],
        steps={n: {key: d[key] for key in (
            'ms', 'device_ms', 'plain_ms', 'library_ms', 'library_device_ms',
            'bound_ms', 'bound_by')} for n, d in p2['dummy'].items()}))
    for st, k in p3['stages'].items():
        kernels.append(dict(
            name=f'spc_trace_kernel<STAGE={st}>', route='cuda',
            source=trace_src, replaces='scripts/probe_r5_kbisect.py:32',
            launches=c3[f'stage{st}'], main_path_launches=0,
            max_abs_err=p3['max_abs_err'][st], ms=k['ms'],
            plain_ms=k['plain_ms'], bound_ms=p3['bound_ms'],
            bound_by=p3['bound_by'], library_ms=None))
    print(f'chip_smoke.py total: {time.perf_counter() - start:.1f} s')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

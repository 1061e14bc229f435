"""Triangle mesh metrics: point-to-mesh distance, edge length, smoothing.

Port of ``kaolin_tpu/metrics/trianglemesh.py``.  The closest face is chosen
by a chunked sweep of every (point, face) pair with no gradient; the
distance is recomputed differentiably on the chosen face.

Distance types: 0 face plane, 1-3 vertices, 4-6 edges.
"""

import torch

from kaolin_tpu_torch.ops.mesh.mesh import _edge_degrees, _unique_edges

__all__ = ['point_to_mesh_distance', 'average_edge_length',
           'uniform_laplacian_smoothing']

# (point, face) pairs per sweep step: ~30 (chunk, F, 3) float32 temporaries
_SWEEP_PAIRS = 2 ** 22


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _closest_point_on_tri(points, v1, v2, v3):
    """Closest point on triangle(s) and its distance type.

    points: (..., 3); v1/v2/v3: (..., 3), broadcast against points.

    Returns:
        (closest (..., 3), dist_type (...,) int32).
    """
    e21 = v2 - v1
    e32 = v3 - v2
    e13 = v1 - v3
    normals = -torch.linalg.cross(*torch.broadcast_tensors(e21, e13),
                                  dim=-1)

    def proj_edge(v, e, p):
        return _dot(p - v, e) / _dot(e, e)

    uab = proj_edge(v1, e21, points)
    ubc = proj_edge(v2, e32, points)
    uca = proj_edge(v3, e13, points)

    def not_above(v, e, p):
        edge_norm = torch.linalg.cross(
            *torch.broadcast_tensors(normals, e), dim=-1)
        return _dot(edge_norm, p - v) <= 0

    is_type1 = (uca > 1.) & (uab < 0.)
    is_type2 = (uab > 1.) & (ubc < 0.)
    is_type3 = (ubc > 1.) & (uca < 0.)
    is_type4 = (uab >= 0.) & (uab <= 1.) & not_above(v1, e21, points)
    is_type5 = (ubc >= 0.) & (ubc <= 1.) & not_above(v2, e32, points)
    is_type6 = (uca >= 0.) & (uca <= 1.) & not_above(v3, e13, points)

    # the types add up, as the reference's dist_type does
    all_types = (is_type1 * 1 + is_type2 * 2 + is_type3 * 3
                 + is_type4 * 4 + is_type5 * 5 + is_type6 * 6)

    unit_normal = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
    plane_pt = points - unit_normal * _dot(points - v1,
                                           unit_normal)[..., None]

    def point_at(v, e, u):
        return v + e * u[..., None]

    # the reference assigns the closest point type by type, 0 to 6, later
    # types overwriting: the higher type wins where two hold
    closest = torch.where(
        is_type6[..., None], point_at(v3, e13, uca), torch.where(
            is_type5[..., None], point_at(v2, e32, ubc), torch.where(
                is_type4[..., None], point_at(v1, e21, uab), torch.where(
                    is_type3[..., None], v3, torch.where(
                        is_type2[..., None], v2, torch.where(
                            is_type1[..., None], v1, plane_pt))))))
    return closest, all_types.to(torch.int32)


def _unbatched_point_to_mesh(points, face_vertices, chunk_size):
    P, F = points.shape[0], face_vertices.shape[0]
    rows = chunk_size or max(1, _SWEEP_PAIRS // max(1, F))
    with torch.no_grad():
        fv = face_vertices.detach()
        v1, v2, v3 = fv[:, 0][None], fv[:, 1][None], fv[:, 2][None]
        idx = []
        for lo in range(0, P, rows):
            p = points[lo:lo + rows].detach()[:, None, :]
            closest, _ = _closest_point_on_tri(p, v1, v2, v3)
            d = torch.sum((closest - p) ** 2, dim=-1)        # (chunk, F)
            idx.append(torch.argmin(d, dim=1))
        idx = torch.cat(idx)

    sel = face_vertices[idx]  # (P, 3, 3)
    closest, dist_type = _closest_point_on_tri(
        points, sel[:, 0], sel[:, 1], sel[:, 2])
    dist = torch.sum((closest - points) ** 2, dim=-1)
    return dist, idx, dist_type


def point_to_mesh_distance(pointclouds, face_vertices, chunk_size=None):
    """Squared distance from points to the closest mesh face, with the
    index of that face and the type of its closest feature.

    Args:
        pointclouds: ``(B, P, 3)``.
        face_vertices: ``(B, F, 3, 3)``.
        chunk_size: points per sweep step (default: ~4 M pairs).

    Returns:
        (distance ``(B, P)`` differentiable, face_idx ``(B, P)`` int64,
        dist_type ``(B, P)`` int32).
    """
    out = [_unbatched_point_to_mesh(p, f, chunk_size)
           for p, f in zip(pointclouds, face_vertices)]
    return tuple(torch.stack(x) for x in zip(*out))


def average_edge_length(vertices, faces):
    """Average of the three edge lengths of each face: ``(B, F)``."""
    faces = torch.as_tensor(faces, device=vertices.device).long()
    p1 = vertices[:, faces[:, 0]]
    p2 = vertices[:, faces[:, 1]]
    p3 = vertices[:, faces[:, 2]]
    el1 = torch.linalg.norm(p2 - p1, dim=2)
    el2 = torch.linalg.norm(p3 - p1, dim=2)
    el3 = torch.linalg.norm(p2 - p3, dim=2)
    return (el1 + el2 + el3) / 3.


def uniform_laplacian_smoothing(vertices, faces):
    """One step of uniform laplacian smoothing: ``V + L V``.

    ``L V`` is formed from the unique-edge list (a neighbour sum by
    ``index_add``, divided by the degree, less the vertex), not from the
    dense ``(V, V)`` :func:`~kaolin_tpu_torch.ops.mesh.uniform_laplacian`;
    isolated vertices keep ``L V = 0``.
    """
    V = vertices.shape[1]
    faces = torch.as_tensor(faces, device=vertices.device)
    edges = _unique_edges(faces, V)
    deg = _edge_degrees(edges, V, vertices.dtype)
    nbr = torch.zeros_like(vertices).index_add(
        1, edges[:, 0], vertices[:, edges[:, 1]])
    lv = torch.where((deg > 0)[None, :, None],
                     nbr / torch.where(deg > 0, deg, 1.)[None, :, None]
                     - vertices, 0.)
    return lv + vertices

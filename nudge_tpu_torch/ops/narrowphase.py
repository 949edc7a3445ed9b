"""Narrowphase: box-box SAT over 15 axes + closed-form face clip, and the
one-point box-sphere and sphere-sphere contacts (PyTorch port of
`nudge_tpu.ops.narrowphase`).

`box_sphere` and `sphere_sphere` are the plain twins of the CUDA kernel in
csrc/narrowphase_1pt.cu. `box_box` is the plain twin of the CUDA kernel in
csrc/narrowphase.cu: the same math batched over candidate pairs with
tensors, where the reference writes it per pair and vmaps it. Per-pair
dynamic axis choices (reference axis, incident axis, edge pair) become
gathers along a small last dimension.

  - SAT over the 15 classic axes with |R| + _ABS_EPS robustness; an edge
    axis must beat the best face axis by 5% (_FACE_EDGE_BIAS);
  - face case: the polygon "incident quad ∩ reference rect" is spanned by
    24 fixed candidates (4 incident verts, 4 rect corners, 16 edge-line
    crossings), reduced to <= 4 points (deepest, farthest, two max-|area|);
  - edge case: closest points of the two supporting edges;
  - first-max argmax tie-breaking everywhere (torch.argmax and the
    reference's jnp.argmax both return the first maximum).

Feature ids are the candidate slot plus face identity bits (face case) or
1024 + edge pair + support signs (edge case), exactly as the reference's.
Sums that the reference writes as small matrix products are spelled out in
index order, one rounding per operation, and the CUDA kernel (built without
FMA contraction) repeats them operation for operation. The reference's XLA
program contracts multiply-adds into FMAs instead, so the two differ in the
last bit, and where the reduction faces an exact tie (the |area| of a
parallelogram's two free corners) the two may order those points
differently; the set of points and their feature ids stays the same.
"""

from __future__ import annotations

import torch

from ..config import CONTACT_POINTS as BOX_BOX_POINTS  # noqa: F401
from ..mathx import quat_to_mat

_FACE_EDGE_BIAS = 0.95   # edge axis must beat the best face axis by 5%
_ABS_EPS = 1e-5          # added to |R| (near-parallel robustness)
_BIG_NEG = -1e30

_I1 = (1, 2, 0)
_I2 = (2, 0, 1)


def _dot3(x0, y0, x1, y1, x2, y2):
    """x0·y0 + x1·y1 + x2·y2, summed left to right."""
    return x0 * y0 + x1 * y1 + x2 * y2


def _mv(M, v):
    """M @ v for [...,3,3] x [...,3]."""
    return _dot3(M[..., :, 0], v[..., None, 0], M[..., :, 1], v[..., None, 1],
                 M[..., :, 2], v[..., None, 2])


def _mtv(M, v):
    """M^T @ v."""
    return _dot3(M[..., 0, :], v[..., None, 0], M[..., 1, :], v[..., None, 1],
                 M[..., 2, :], v[..., None, 2])


def _mtm(A, B):
    """A^T @ B for [...,3,3] pairs."""
    return _dot3(A[..., 0, :, None], B[..., 0, None, :],
                 A[..., 1, :, None], B[..., 1, None, :],
                 A[..., 2, :, None], B[..., 2, None, :])


def _rowmat(x, M):
    """x @ M^T for points x[P,K,3] and matrices M[P,3,3]."""
    return _dot3(x[..., 0:1], M[:, None, :, 0], x[..., 1:2], M[:, None, :, 1],
                 x[..., 2:3], M[:, None, :, 2])


def _argmax(x):
    """Index of the first maximum along the last dim (torch.argmax returns
    the first, as jnp.argmax does)."""
    return torch.argmax(x, dim=-1)


def _take(x, idx):
    """x[..., idx] with a per-row index tensor idx[...] (last-dim gather)."""
    return torch.gather(x, -1, idx.unsqueeze(-1)).squeeze(-1)


def _reduce_manifold(uv, depth, valid):
    """Pick <= 4 representatives of the [P,K] candidates: deepest, farthest
    from it, then the two max-|area| extremes. Returns (idx[P,4], valid[P,4])."""
    K = uv.shape[-2]
    idxs = torch.arange(K, device=uv.device)
    neg = torch.tensor(_BIG_NEG, dtype=uv.dtype, device=uv.device)

    s0 = torch.where(valid, depth, neg)
    i0 = _argmax(s0)
    v0 = torch.any(valid, -1)
    remaining = valid & (idxs != i0[:, None])

    u0 = _take(uv[..., 0], i0)
    w0 = _take(uv[..., 1], i0)
    du = uv[..., 0] - u0[:, None]
    dv = uv[..., 1] - w0[:, None]
    d1 = du * du + dv * dv
    i1 = _argmax(torch.where(remaining, d1, neg))
    v1 = torch.any(remaining, -1)
    remaining = remaining & (idxs != i1[:, None])

    e0 = _take(uv[..., 0], i1) - u0
    e1 = _take(uv[..., 1], i1) - w0
    area = e0[:, None] * dv - e1[:, None] * du
    i2 = _argmax(torch.where(remaining, torch.abs(area), neg))
    v2 = torch.any(remaining, -1)
    a2 = _take(area, i2)
    remaining = remaining & (idxs != i2[:, None])

    opposite = -torch.sign(a2)[:, None] * area
    i3 = _argmax(torch.where(remaining, opposite, neg))
    v3 = torch.any(remaining, -1)
    return (torch.stack([i0, i1, i2, i3], -1),
            torch.stack([v0, v1, v2, v3], -1))


def box_box(ha, qa, pa, hb, qb, pb):
    """Collide oriented boxes A[P] and B[P]. Returns a dict of pos[P,4,3]
    (world), normal[P,3] (A -> B), depth[P,4], feat[P,4] i32, valid[P,4]."""
    dev, f32 = ha.device, ha.dtype
    P = ha.shape[0]
    ar = torch.arange(P, device=dev)
    Ra = quat_to_mat(qa)
    Rb = quat_to_mat(qb)
    R = _mtm(Ra, Rb)                      # B axes in A frame
    t = _mtv(Ra, pb - pa)                 # B center in A frame
    absR = torch.abs(R) + _ABS_EPS

    # --- 6 face axes ---
    sA = torch.abs(t) - (ha + _mv(absR, hb))
    tB = _mtv(R, t)
    sB = torch.abs(tB) - (_mtv(absR, ha) + hb)
    s_face = torch.cat([sA, sB], -1)                      # [P,6]
    best_face = _argmax(s_face)
    s_face_best = _take(s_face, best_face)

    # --- 9 edge-edge axes: axis(i,j) = cross(a_i, b_j) ---
    i1, i2 = list(_I1), list(_I2)
    b_term = hb[:, None, i1] * absR[:, :, i2] + hb[:, None, i2] * absR[:, :, i1]
    num = (torch.abs(t[:, i2, None] * R[:, i1, :] - t[:, i1, None] * R[:, i2, :])
           - ha[:, i1, None] * absR[:, i2, :]
           - ha[:, i2, None] * absR[:, i1, :]
           - b_term)                                      # [P,3(i),3(j)]
    L2 = R[:, i1, :] ** 2 + R[:, i2, :] ** 2
    L = torch.sqrt(torch.clamp_min(L2, 1e-12))
    s_edge = torch.where(L2 > 1e-6, num / L,
                         torch.tensor(-float("inf"), dtype=f32, device=dev))
    s_edge = s_edge.reshape(P, 9)
    best_edge = _argmax(s_edge)
    s_edge_best = _take(s_edge, best_edge)

    separated = torch.maximum(s_face_best, s_edge_best) > 0.0
    pen_face = -s_face_best
    pen_edge = -s_edge_best
    edge_case = (pen_edge < pen_face * _FACE_EDGE_BIAS) & torch.isfinite(pen_edge)

    # ------------------------------------------------------------------
    # FACE CASE
    # ------------------------------------------------------------------
    ref_is_b = best_face >= 3
    axis = best_face % 3
    rb3 = ref_is_b[:, None, None]
    R_ri = torch.where(rb3, R.transpose(-1, -2), R)
    t_ri = torch.where(ref_is_b[:, None], -tB, t)
    h_ref = torch.where(ref_is_b[:, None], hb, ha)
    h_inc = torch.where(ref_is_b[:, None], ha, hb)
    nsign = torch.where(_take(t_ri, axis) >= 0.0, 1.0, -1.0)

    w = axis
    u = (axis + 1) % 3
    v = (axis + 2) % 3

    nd = R_ri[ar, w, :] * nsign[:, None]                  # row w of R_ri
    b_axis = _argmax(torch.abs(nd))
    s_inc = -torch.sign(_take(nd, b_axis))
    b1 = (b_axis + 1) % 3
    b2 = (b_axis + 2) % 3

    su = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=f32, device=dev)
    sv = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=f32, device=dev)
    # incident corners in the incident frame: component b_axis is
    # s_inc*h[b_axis], b1 is su*h[b1], b2 is sv*h[b2]
    c_b = (s_inc * _take(h_inc, b_axis))[:, None].expand(P, 4)
    c_1 = su[None, :] * _take(h_inc, b1)[:, None]
    c_2 = sv[None, :] * _take(h_inc, b2)[:, None]
    comps = torch.zeros((P, 4, 3), dtype=f32, device=dev)
    comps.scatter_(2, b_axis[:, None, None].expand(P, 4, 1), c_b[..., None])
    comps.scatter_(2, b1[:, None, None].expand(P, 4, 1), c_1[..., None])
    comps.scatter_(2, b2[:, None, None].expand(P, 4, 1), c_2[..., None])
    # pts0 = corners @ R_ri^T + t_ri
    pts0 = _rowmat(comps, R_ri) + t_ri[:, None, :]

    eps = 1e-6
    h_u, h_v, h_w = _take(h_ref, u), _take(h_ref, v), _take(h_ref, w)
    qu = _take(pts0, u[:, None].expand(P, 4))             # [P,4]
    qv = _take(pts0, v[:, None].expand(P, 4))
    nxt = [1, 2, 3, 0]
    qu_n = qu[:, nxt]
    qv_n = qv[:, nxt]

    # type A: incident verts inside the rect
    val_a = (torch.abs(qu) <= (h_u + eps)[:, None]) & \
        (torch.abs(qv) <= (h_v + eps)[:, None])

    # type B: rect corners inside the incident quad
    cu = su[None, :] * h_u[:, None]                       # [P,4]
    cv = sv[None, :] * h_v[:, None]
    eu = (qu_n - qu)[:, None, :]                          # [P,1,4] edges
    ev = (qv_n - qv)[:, None, :]
    crossc = eu * (cv[:, :, None] - qv[:, None, :]) \
        - ev * (cu[:, :, None] - qu[:, None, :])          # [P,4c,4e]
    ar2 = qu * qv_n - qu_n * qv
    area2 = ((ar2[:, 0] + ar2[:, 1]) + ar2[:, 2]) + ar2[:, 3]
    sgn = torch.where(area2 >= 0.0, 1.0, -1.0)
    val_b = torch.all(sgn[:, None, None] * crossc >= -eps, dim=2)
    n_inc = _take(R_ri, b_axis[:, None].expand(P, 3)) * s_inc[:, None]
    d_pl = n_inc[:, 0] * pts0[:, 0, 0] + n_inc[:, 1] * pts0[:, 0, 1] \
        + n_inc[:, 2] * pts0[:, 0, 2]
    n_w = _take(n_inc, w)
    n_w_safe = torch.where(torch.abs(n_w) > 1e-3, n_w,
                           torch.full_like(n_w, 1e-3))
    cw = (d_pl[:, None] - _take(n_inc, u)[:, None] * cu
          - _take(n_inc, v)[:, None] * cv) / n_w_safe[:, None]
    pos_b3 = torch.zeros((P, 4, 3), dtype=f32, device=dev)
    pos_b3.scatter_(2, u[:, None, None].expand(P, 4, 1), cu[..., None])
    pos_b3.scatter_(2, v[:, None, None].expand(P, 4, 1), cv[..., None])
    pos_b3.scatter_(2, w[:, None, None].expand(P, 4, 1), cw[..., None])
    val_b = val_b & (torch.abs(n_w) > 1e-3)[:, None]

    # type C: 4 incident edges x 4 rect border lines (u = ±h_u, v = ±h_v)
    line_val = torch.stack([h_u, -h_u, h_v, -h_v], -1)    # [P,4]
    is_u = torch.tensor([True, True, False, False], device=dev)
    src = torch.where(is_u[None, None, :], qu[:, :, None], qv[:, :, None])
    dst = torch.where(is_u[None, None, :], qu_n[:, :, None], qv_n[:, :, None])
    den = dst - src
    den = torch.where(torch.abs(den) > 1e-9, den, torch.full_like(den, 1e-9))
    tt = (line_val[:, None, :] - src) / den               # [P,4e,4l]
    other = torch.where(is_u[None, None, :], qv[:, :, None], qu[:, :, None])
    other_n = torch.where(is_u[None, None, :], qv_n[:, :, None],
                          qu_n[:, :, None])
    oth = other + tt * (other_n - other)
    oth_h = torch.where(is_u[None, None, :], h_v[:, None, None],
                        h_u[:, None, None])
    val_c = (tt >= -eps) & (tt <= 1.0 + eps) & (torch.abs(oth) <= oth_h + eps)
    pos_c3 = pts0[:, :, None, :] + tt[..., None] * (
        pts0[:, nxt][:, :, None, :] - pts0[:, :, None, :])   # [P,4,4,3]

    cand = torch.cat([pts0, pos_b3, pos_c3.reshape(P, 16, 3)], 1)   # [P,24,3]
    cand_valid = torch.cat([val_a, val_b, val_c.reshape(P, 16)], 1)
    cand_w = _take(cand, w[:, None].expand(P, 24))
    depth_all = h_w[:, None] - nsign[:, None] * cand_w
    valid_all = cand_valid & (depth_all > 0.0)

    uv = torch.stack([_take(cand, u[:, None].expand(P, 24)),
                      _take(cand, v[:, None].expand(P, 24))], -1)
    keep_idx, keep_valid = _reduce_manifold(uv, depth_all, valid_all)
    pts4 = torch.gather(cand, 1, keep_idx[..., None].expand(P, 4, 3))
    depth_f = torch.gather(depth_all, 1, keep_idx)
    valid_f = keep_valid & torch.gather(valid_all, 1, keep_idx)

    Rref = torch.where(rb3, Rb, Ra)
    pref = torch.where(ref_is_b[:, None], pb, pa)
    pos_f = _rowmat(pts4, Rref) + pref[:, None, :]
    n_ref_world = _take(Rref, axis[:, None].expand(P, 3)) * nsign[:, None]
    normal_f = torch.where(ref_is_b[:, None], -n_ref_world, n_ref_world)

    feat_f = (keep_idx.to(torch.int32)
              + (ref_is_b.to(torch.int32) << 5)[:, None]
              + (axis.to(torch.int32) << 6)[:, None]
              + ((nsign > 0).to(torch.int32) << 8)[:, None])

    # ------------------------------------------------------------------
    # EDGE CASE
    # ------------------------------------------------------------------
    ei = best_edge // 3
    ej = best_edge % 3
    e = torch.eye(3, dtype=f32, device=dev)
    e_i = e[ei]                                           # [P,3]
    e_j = e[ej]
    Rj = _take(R, ej[:, None].expand(P, 3))               # column ej of R
    ax_x = e_i[:, 1] * Rj[:, 2] - e_i[:, 2] * Rj[:, 1]
    ax_y = e_i[:, 2] * Rj[:, 0] - e_i[:, 0] * Rj[:, 2]
    ax_z = e_i[:, 0] * Rj[:, 1] - e_i[:, 1] * Rj[:, 0]
    axis_a = torch.stack([ax_x, ax_y, ax_z], -1)
    nrm = torch.sqrt(torch.clamp_min(
        ax_x * ax_x + ax_y * ax_y + ax_z * ax_z, 1e-24))
    axis_a = axis_a / nrm[:, None]
    dat = axis_a[:, 0] * t[:, 0] + axis_a[:, 1] * t[:, 1] + axis_a[:, 2] * t[:, 2]
    axis_a = axis_a * torch.where(dat >= 0.0, 1.0, -1.0)[:, None]

    sa = torch.sign(axis_a) + (axis_a == 0.0).to(f32)
    c1 = sa * ha * (1.0 - e_i)
    d1 = e_i
    axis_b = -_mtv(R, axis_a)
    sb = torch.sign(axis_b) + (axis_b == 0.0).to(f32)
    c2 = _mv(R, sb * hb * (1.0 - e_j)) + t
    d2 = Rj

    def dot3(x, y):
        return x[:, 0] * y[:, 0] + x[:, 1] * y[:, 1] + x[:, 2] * y[:, 2]

    r12 = c2 - c1
    b_dd = dot3(d1, d2)
    denom = torch.clamp_min(1.0 - b_dd * b_dd, 1e-9)
    ha_ei = _take(ha, ei)
    hb_ej = _take(hb, ej)
    d1r = dot3(d1, r12)
    d2r = dot3(d2, r12)
    s_par = torch.minimum(torch.maximum((d1r - b_dd * d2r) / denom, -ha_ei),
                          ha_ei)
    u_par = torch.minimum(torch.maximum((b_dd * d1r - d2r) / denom, -hb_ej),
                          hb_ej)
    mid = 0.5 * ((c1 + s_par[:, None] * d1) + (c2 + u_par[:, None] * d2))
    pos_e = _mv(Ra, mid) + pa
    normal_e = _mv(Ra, axis_a)
    i1t = torch.tensor(_I1, device=dev)
    i2t = torch.tensor(_I2, device=dev)
    sign_bits = (
        (_take(sa, i1t[ei]) > 0).to(torch.int32)
        + 2 * (_take(sa, i2t[ei]) > 0).to(torch.int32)
        + 4 * (_take(sb, i1t[ej]) > 0).to(torch.int32)
        + 8 * (_take(sb, i2t[ej]) > 0).to(torch.int32)
    )
    feat_e = 1024 + (ei * 3 + ej).to(torch.int32) * 16 + sign_bits

    # ------------------------------------------------------------------
    # select + gate
    # ------------------------------------------------------------------
    first = torch.tensor([True, False, False, False], device=dev)
    ec = edge_case[:, None]
    pos = torch.where(ec[..., None],
                      torch.where(first[None, :, None], pos_e[:, None, :], 0.0),
                      pos_f)
    depth = torch.where(ec, torch.where(first[None, :], pen_edge[:, None], 0.0),
                        depth_f)
    feat = torch.where(ec, torch.where(first[None, :], feat_e[:, None], 0),
                       feat_f).to(torch.int32)
    valid_e = first[None, :] & (pen_edge > 0.0)[:, None]
    valid = torch.where(ec, valid_e, valid_f) & ~separated[:, None]
    normal = torch.where(ec, normal_e, normal_f)
    return {"pos": pos, "normal": normal, "depth": depth, "feat": feat,
            "valid": valid}


def box_sphere(h, qa, pa, radius, pb):
    """Box A[P] against sphere B[P]: one contact each. Returns a dict of
    pos[P,3] (world), normal[P,3] (A -> B), depth[P] and valid[P]; the
    feature id is always 0. Every 3x3 product is summed in index order, as
    csrc/narrowphase_1pt.cu does."""
    Ra = quat_to_mat(qa)
    c = _mtv(Ra, pb - pa)                 # sphere centre in the box frame
    clamped = torch.minimum(torch.maximum(c, -h), h)
    delta = c - clamped
    d2 = (delta[:, 0] * delta[:, 0] + delta[:, 1] * delta[:, 1]
          + delta[:, 2] * delta[:, 2])
    outside = d2 > 1e-12
    dist = torch.sqrt(torch.clamp_min(d2, 1e-12))

    # centre outside the box: push along centre-to-closest-point
    n_out = delta / dist[:, None]
    depth_out = radius - dist

    # centre inside the box: push out through the least-penetrated face
    # (torch.argmin takes the first minimum, as jnp.argmin does)
    face_pen = h - torch.abs(c)
    k = torch.argmin(face_pen, dim=-1)
    sgn = torch.where(_take(c, k) >= 0.0, 1.0, -1.0)
    on_k = torch.arange(3, device=h.device)[None, :] == k[:, None]
    n_in = torch.where(on_k, sgn[:, None], 0.0)
    depth_in = radius + _take(face_pen, k)
    pos_in = torch.where(on_k, sgn[:, None] * h, c)

    n_local = torch.where(outside[:, None], n_out, n_in)
    depth = torch.where(outside, depth_out, depth_in)
    pos_local = torch.where(outside[:, None], clamped, pos_in)
    return {"pos": _mv(Ra, pos_local) + pa, "normal": _mv(Ra, n_local),
            "depth": depth, "valid": depth > 0.0}


def sphere_sphere(ra, pa, rb, pb):
    """Sphere A[P] against sphere B[P]: one contact at the overlap midpoint
    (same dict as box_sphere)."""
    d = pb - pa
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    dist = torch.sqrt(torch.clamp_min(d2, 1e-12))
    up = torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype, device=d.device)
    n = torch.where((d2 > 1e-12)[:, None], d / dist[:, None], up)
    depth = (ra + rb) - dist
    pos = pa + n * (ra - 0.5 * depth)[:, None]
    return {"pos": pos, "normal": n, "depth": depth, "valid": depth > 0.0}

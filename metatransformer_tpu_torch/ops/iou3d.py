"""Rotated 3D box IoU and NMS.

Port of ``metatransformer_tpu/ops/iou3d.py``, which replaces pcdet's
iou3d_nms CUDA kernels. Boxes are (x, y, z, dx, dy, dz, heading), the pcdet
convention.

The BEV overlap of two rotated rectangles is Sutherland-Hodgman polygon
clipping, vectorised over every pair with a fixed vertex budget (a
rectangle clipped by a rectangle has at most 8 vertices): no branch, no
scatter. Every function takes leading batch axes, so a batch of samples
runs as one program where the reference maps a function over the batch.

:func:`nms_bev` is the reference's greedy suppression over the
score-sorted boxes. The reference steps over all n candidates; the port
takes ``max_out`` greedy steps (each keeps the first live box and kills the
boxes it suppresses) and returns the same indices and flags: the first
``max_out`` kept boxes are the first ``max_out`` picks, and where fewer
are kept the picks are the whole keep set. The sort is stable, as
``jnp.argsort``, so tied scores keep their input order.
"""

from __future__ import annotations

import torch

_MAX_VERTS = 16  # 4 + one per clip edge worst case, padded


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] -> BEV corners [..., 4, 2] (counter-clockwise)."""
    x, y = boxes[..., 0], boxes[..., 1]
    dx, dy, yaw = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    lx = torch.stack([dx, -dx, -dx, dx], -1) * 0.5
    ly = torch.stack([dy, dy, -dy, -dy], -1) * 0.5
    gx = lx * c[..., None] - ly * s[..., None] + x[..., None]
    gy = lx * s[..., None] + ly * c[..., None] + y[..., None]
    return torch.stack([gx, gy], -1)


def _next_vertex(verts: torch.Tensor, nvalid: torch.Tensor):
    """(slot index [..., V], the vertex after each slot [..., V, 2]): the
    slot after the last valid one wraps to 0."""
    v = verts.shape[-2]
    idxv = torch.arange(v, device=verts.device).expand(verts.shape[:-1])
    nxt = torch.where(idxv + 1 >= nvalid[..., None], 0, idxv + 1)
    vn = verts.gather(-2, nxt[..., None].expand(*nxt.shape, 2))
    return idxv, vn


def _polygon_area(verts: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """Shoelace over a padded vertex list [..., V, 2] with nvalid [...]."""
    idxv, vn = _next_vertex(verts, nvalid)
    mask = idxv < nvalid[..., None]
    contrib = (verts[..., 0] * vn[..., 1] - vn[..., 0] * verts[..., 1]) * mask
    return contrib.sum(-1).abs() * 0.5


def _clip_polygon(verts, nvalid, a, b):
    """Clip a padded polygon by the half-plane left of segment a->b (one
    Sutherland-Hodgman step). verts [..., V, 2]; a, b [..., 2]."""
    v = verts.shape[-2]
    idxv, vn = _next_vertex(verts, nvalid)
    d = b - a

    def side(p):
        return d[..., None, 0] * (p[..., 1] - a[..., None, 1]) - d[..., None, 1] * (
            p[..., 0] - a[..., None, 0])

    s1, s2 = side(verts), side(vn)
    inside1, inside2 = s1 >= 0, s2 >= 0
    denom = s1 - s2
    t = s1 / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    inter = verts + (vn - verts) * t[..., None]
    valid_slot = idxv < nvalid[..., None]
    # each input edge emits up to 2 vertices: its start (if inside) and its
    # crossing (if it crosses), in edge order: vertex i, then crossing i
    emit = torch.stack([inside1 & valid_slot, (inside1 != inside2) & valid_slot], -1)
    out = torch.stack([verts, inter], -2)  # [..., V, 2 (vertex, crossing), 2]
    emit = emit.reshape(*emit.shape[:-2], 2 * v)
    out = out.reshape(*out.shape[:-3], 2 * v, 2)
    # compact: stable sort by (not emit)
    perm = torch.sort((~emit).to(torch.uint8), dim=-1, stable=True).indices
    out = out.gather(-2, perm[..., None].expand(*perm.shape, 2))
    new_n = emit.sum(-1)
    return out[..., :_MAX_VERTS, :], new_n.clamp_max(_MAX_VERTS)


def rotated_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """BEV intersection areas [..., N, M] of rotated boxes [..., N, 7] x
    [..., M, 7]."""
    ca = box_corners_bev(boxes_a)  # [..., N, 4, 2]
    cb = box_corners_bev(boxes_b)  # [..., M, 4, 2]
    n, m = ca.shape[-3], cb.shape[-3]
    lead = torch.broadcast_shapes(ca.shape[:-3], cb.shape[:-3])
    verts = ca[..., :, None, :, :].expand(*lead, n, m, 4, 2)
    verts = torch.cat([verts, verts.new_zeros(*lead, n, m, _MAX_VERTS - 4, 2)], -2)
    nvalid = torch.full((*lead, n, m), 4, dtype=torch.long, device=ca.device)
    for e in range(4):
        a = cb[..., None, :, e, :].expand(*lead, n, m, 2)
        b = cb[..., None, :, (e + 1) % 4, :].expand(*lead, n, m, 2)
        verts, nvalid = _clip_polygon(verts, nvalid, a, b)
    area = _polygon_area(verts, nvalid)
    return torch.where(nvalid >= 3, area, 0.0)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """3D IoU [..., N, M] (BEV overlap x z-overlap, pcdet boxes_iou3d_gpu)."""
    overlap_bev = rotated_overlap_bev(boxes_a, boxes_b)
    za1 = boxes_a[..., 2] - boxes_a[..., 5] / 2
    za2 = boxes_a[..., 2] + boxes_a[..., 5] / 2
    zb1 = boxes_b[..., 2] - boxes_b[..., 5] / 2
    zb2 = boxes_b[..., 2] + boxes_b[..., 5] / 2
    zo = (torch.minimum(za2[..., :, None], zb2[..., None, :])
          - torch.maximum(za1[..., :, None], zb1[..., None, :])).clamp_min(0.0)
    inter = overlap_bev * zo
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    return inter / (vol_a[..., :, None] + vol_b[..., None, :] - inter).clamp_min(1e-6)


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.7,
            max_out: int = 128):
    """Greedy rotated-BEV NMS (pcdet nms_gpu semantics), batched: boxes
    [..., N, 7], scores [..., N] -> (indices [..., max_out] int64, valid
    [..., max_out]).

    The indices point into ``boxes``: the kept boxes by descending score,
    then, where fewer than ``max_out`` are kept, the suppressed ones in the
    same order (flagged invalid), as the reference returns them. Runs on
    the device without reading a value back; carries no gradient."""
    lead = boxes.shape[:-2]
    boxes = boxes.detach().reshape(-1, *boxes.shape[-2:])
    scores = scores.detach().reshape(-1, scores.shape[-1])
    b, n = scores.shape
    if max_out > n:
        raise ValueError(f"max_out {max_out} exceeds the {n} candidates")
    order = torch.sort(-scores, dim=-1, stable=True).indices  # [B, N]
    sb = boxes.gather(1, order[..., None].expand(b, n, 7))
    bev = rotated_overlap_bev(sb, sb)
    area = sb[..., 3] * sb[..., 4]
    iou = bev / (area[..., :, None] + area[..., None, :] - bev).clamp_min(1e-6)
    # suppressed[b, i, j]: box i dies if box j (earlier) is kept: iou[i, j]
    suppressed = iou > iou_threshold
    pos = torch.arange(n, device=boxes.device)
    live = torch.ones(b, n, dtype=torch.bool, device=boxes.device)
    keep = torch.zeros(b, n + 1, dtype=torch.bool, device=boxes.device)  # n: a spare slot
    for _ in range(max_out):
        j = live.to(torch.uint8).argmax(-1)  # the first live box
        ok = live.gather(1, j[:, None])[:, 0]
        keep.scatter_(1, torch.where(ok, j, n)[:, None], True)
        dies = suppressed.gather(2, j[:, None, None].expand(b, n, 1))[..., 0] | (pos == j[:, None])
        live = live & ~(dies & ok[:, None])
    keep = keep[:, :n]
    rank = torch.where(keep, pos, n + 1)
    sel = torch.sort(rank, dim=-1, stable=True).indices[:, :max_out]
    valid = keep.gather(1, sel) & (keep.sum(-1, keepdim=True) > pos[:max_out])
    idx = order.gather(1, sel)
    return idx.reshape(*lead, max_out), valid.reshape(*lead, max_out)

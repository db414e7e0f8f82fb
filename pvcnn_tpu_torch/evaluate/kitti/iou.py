"""Rotated bird's-eye-view box IoU (counterpart of
pvcnn_tpu/evaluate/kitti/iou.py; reference evaluate/kitti/utils/iou.py, a
numba.cuda N x K kernel), restated here so that the port imports nothing of
the JAX package (tests/test_torch_kitti_eval.py holds the two equal).

Host-side numpy reimplementation: rotated rectangles -> Sutherland-Hodgman convex
clipping -> shoelace area, with a bounding-circle prefilter so only genuinely
overlapping pairs pay for the polygon clip. The reference runs the full N x K
matrix on GPU; the evaluation here only ever asks for per-image matrices (a few
boxes each), so a prefiltered host loop is fast enough and fully deterministic.

Box format matches the reference launcher: [center_x, center_y, w, h, angle]
(bev: camera x/z, dims, rotation_y).
"""

from __future__ import annotations

import numpy as np

__all__ = ["rotate_iou_eval", "rotated_box_corners"]


def rotated_box_corners(boxes: np.ndarray) -> np.ndarray:
    """[N, 5] (cx, cy, w, h, angle) -> [N, 4, 2] corners, counter-clockwise."""
    cx, cy, w, h, a = boxes.T
    dx = np.stack([w, w, -w, -w], axis=1) * 0.5       # CCW in box frame
    dy = np.stack([-h, h, h, -h], axis=1) * 0.5
    cos, sin = np.cos(a)[:, None], np.sin(a)[:, None]
    # rotation by -a matches the KITTI convention (rotation_y is clockwise when
    # viewed from +y); IoU is invariant to a global flip so orientation consistency
    # is all that matters
    x = cx[:, None] + cos * dx + sin * dy
    y = cy[:, None] - sin * dx + cos * dy
    return np.stack([x, y], axis=-1)


def _polygon_area(pts) -> float:
    x = np.array([p[0] for p in pts])
    y = np.array([p[1] for p in pts])
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _clip(subject, clip_poly):
    """Sutherland-Hodgman; clip_poly must be convex and consistently wound."""

    def inside(p, cp1, cp2):
        return ((cp2[0] - cp1[0]) * (p[1] - cp1[1])
                - (cp2[1] - cp1[1]) * (p[0] - cp1[0])) >= 0

    def intersect(cp1, cp2, s, e):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (s[0] - e[0], s[1] - e[1])
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        d = dc[0] * dp[1] - dc[1] * dp[0]
        if d == 0:
            return e
        return ((n1 * dp[0] - n2 * dc[0]) / d, (n1 * dp[1] - n2 * dc[1]) / d)

    out = [tuple(p) for p in subject]
    cp1 = tuple(clip_poly[-1])
    for cp2 in map(tuple, clip_poly):
        if not out:
            return []
        src, out = out, []
        s = src[-1]
        for e in src:
            if inside(e, cp1, cp2):
                if not inside(s, cp1, cp2):
                    out.append(intersect(cp1, cp2, s, e))
                out.append(e)
            elif inside(s, cp1, cp2):
                out.append(intersect(cp1, cp2, s, e))
            s = e
        cp1 = cp2
    return out


def rotate_iou_eval(boxes: np.ndarray, qboxes: np.ndarray,
                    criterion: int = -1) -> np.ndarray:
    """[N, 5] x [K, 5] -> [N, K] rotated overlap.

    criterion -1: IoU; 0: intersection/area(box); 1: intersection/area(qbox);
    else: raw intersection area — the same switch as the reference kernel.
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    qboxes = np.asarray(qboxes, dtype=np.float64)
    n, k = boxes.shape[0], qboxes.shape[0]
    out = np.zeros((n, k), dtype=np.float64)
    if n == 0 or k == 0:
        return out

    c1 = rotated_box_corners(boxes)
    c2 = rotated_box_corners(qboxes)
    area1 = boxes[:, 2] * boxes[:, 3]
    area2 = qboxes[:, 2] * qboxes[:, 3]
    rad1 = 0.5 * np.hypot(boxes[:, 2], boxes[:, 3])
    rad2 = 0.5 * np.hypot(qboxes[:, 2], qboxes[:, 3])
    center_d = np.hypot(boxes[:, None, 0] - qboxes[None, :, 0],
                        boxes[:, None, 1] - qboxes[None, :, 1])
    candidates = center_d < (rad1[:, None] + rad2[None, :])

    for i, j in zip(*np.nonzero(candidates)):
        inter_pts = _clip(c1[i], c2[j])
        if len(inter_pts) < 3:
            continue
        inter = _polygon_area(inter_pts)
        if criterion == -1:
            denom = area1[i] + area2[j] - inter
        elif criterion == 0:
            denom = area1[i]
        elif criterion == 1:
            denom = area2[j]
        else:
            denom = 1.0
        out[i, j] = inter / denom if denom > 0 else 0.0
    return out

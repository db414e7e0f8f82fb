"""Rotated 3-D box IoU from box corners (counterpart of
pvcnn_tpu/meters/kitti/utils.py; reference meters/kitti/utils.py:23-140),
restated here so that the port imports nothing of the JAX package
(tests/test_torch_kitti_eval.py holds the two equal).

numpy on the host: Sutherland-Hodgman clipping of the bird's-eye-view
rectangles, the clipped polygon's area by scipy's ConvexHull, times the
height overlap.

Upstream attribution: the polygon_clip / poly_area helpers follow the textbook
Sutherland-Hodgman and shoelace formulations also used by the reference's
meters/kitti/utils.py, which carries an Apache-2.0 header (Charles R. Qi /
Zhijian Liu, from the Frustum-PointNets codebase, itself citing rosettacode's
Sutherland-Hodgman page). This file is an independent numpy re-expression of
those public algorithms; the Apache-2.0 provenance of the protocol is
acknowledged here."""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull

__all__ = ["get_box_iou_3d"]


def poly_area(coords):
    x, y = coords[:, 0], coords[:, 1]
    return 0.5 * np.abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def polygon_clip(subject_polygon, clip_polygon):
    """Clip `subject_polygon` by convex `clip_polygon`; returns vertex list or
    None if the intersection is empty."""

    def inside(p, cp1, cp2):
        return ((cp2[0] - cp1[0]) * (p[1] - cp1[1])
                > (cp2[1] - cp1[1]) * (p[0] - cp1[0]))

    def intersection(cp1, cp2, s, e):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (s[0] - e[0], s[1] - e[1])
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        n3 = 1.0 / (dc[0] * dp[1] - dc[1] * dp[0])
        return [(n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3]

    output_list = list(subject_polygon)
    cp1 = clip_polygon[-1]
    for cp2 in clip_polygon:
        input_list = output_list
        output_list = []
        if not input_list:
            return None
        s = input_list[-1]
        for e in input_list:
            if inside(e, cp1, cp2):
                if not inside(s, cp1, cp2):
                    output_list.append(intersection(cp1, cp2, s, e))
                output_list.append(e)
            elif inside(s, cp1, cp2):
                output_list.append(intersection(cp1, cp2, s, e))
            s = e
        cp1 = cp2
        if not output_list:
            return None
    return output_list


def convex_hull_intersection(p1, pt):
    inter_p = polygon_clip(p1, pt)
    if inter_p is None:
        return None, 0.0
    return inter_p, ConvexHull(inter_p).volume


def box_volume_3d(corners):
    a = np.sqrt(np.sum((corners[:, 0] - corners[:, 1]) ** 2))
    b = np.sqrt(np.sum((corners[:, 1] - corners[:, 2]) ** 2))
    c = np.sqrt(np.sum((corners[:, 0] - corners[:, 4]) ** 2))
    return a * b * c


def _iou_single(corners_1, corners_t):
    c1 = [(corners_1[0, i], corners_1[2, i]) for i in (3, 2, 1, 0)]
    ct = [(corners_t[0, i], corners_t[2, i]) for i in (3, 2, 1, 0)]
    area_1 = poly_area(np.asarray(c1))
    area_2 = poly_area(np.asarray(ct))
    _, inter_area = convex_hull_intersection(c1, ct)
    iou_2d = inter_area / (area_1 + area_2 - inter_area)
    y_max = min(corners_1[1, 0], corners_t[1, 0])
    y_min = max(corners_1[1, 4], corners_t[1, 4])
    inter_vol = inter_area * max(0.0, y_max - y_min)
    vol1, vol2 = box_volume_3d(corners_1), box_volume_3d(corners_t)
    return inter_vol / (vol1 + vol2 - inter_vol), iou_2d


def get_box_iou_3d(corners_1, corners_t):
    """corners [B, 3, 8] (up = -Y, counter-clockwise corner order) ->
    (iou_3d [B], iou_2d [B])."""
    corners_1 = np.asarray(corners_1)
    corners_t = np.asarray(corners_t)
    batch = corners_1.shape[0]
    iou_3d = np.zeros(batch)
    iou_2d = np.zeros(batch)
    for b in range(batch):
        iou_3d[b], iou_2d[b] = _iou_single(corners_1[b], corners_t[b])
    return iou_3d, iou_2d

"""Official KITTI AP evaluation (counterpart of
pvcnn_tpu/evaluate/kitti/official_eval.py; reference
evaluate/kitti/utils/eval.py, itself a port of the public
kitti-object-eval-python), restated here so that the port imports nothing of
the JAX package (tests/test_torch_kitti_eval.py holds the two equal).

Pure-numpy/python re-implementation with one structural change: the reference
computes dense cross-image IoU matrices in 50-image parts (a GPU-friendly shape,
calculate_iou_partly) but only ever *reads* the per-image diagonal blocks; we
compute exactly the per-image matrices, which on the host is both faster and
simpler. Matching semantics (greedy score-ordered assignment, don't-care handling,
41-point precision sampling, 11-point mAP summary) are preserved verbatim.

Upstream attribution: the matching protocol implemented here is the official
KITTI object-detection AP protocol as codified by the public
kitti-object-eval-python project (Apache-2.0), which the reference ports at
evaluate/kitti/utils/eval.py. compute_statistics below preserves that protocol's
semantics by necessity — divergence would be an evaluation bug.
"""

from __future__ import annotations

import io as sysio

import numpy as np

from pvcnn_tpu_torch.evaluate.kitti.iou import rotate_iou_eval

__all__ = ["get_official_eval_result", "do_eval", "eval_class"]

_NO_DETECTION = -10000000


def get_map(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """Axis-aligned 2-D bbox overlap [N, K] (eval.py:31-51)."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    overlaps = np.zeros((n, k), dtype=np.float64)
    if n == 0 or k == 0:
        return overlaps
    lt = np.maximum(boxes[:, None, :2], query_boxes[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:4], query_boxes[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_n = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_k = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        ua = area_n + area_k - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_n, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_k, inter.shape)
    else:
        ua = np.ones_like(inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where((inter > 0) & (ua > 0), inter / ua, 0.0)
    return out


def _bev_boxes(anno, bev_axes):
    return np.concatenate([
        anno["location"][:, bev_axes],
        anno["dimensions"][:, bev_axes],
        anno["rotation_y"][..., None],
    ], axis=1)


def d3_box_overlap(boxes, qboxes, criterion=-1, z_axis=1, z_center=1.0):
    """Rotated BEV intersection x height overlap -> 3-D IoU (eval.py:60-103)."""
    bev_axes = list(range(7))
    bev_axes.pop(z_axis + 3)
    bev_axes.pop(z_axis)
    rinc = rotate_iou_eval(boxes[:, bev_axes], qboxes[:, bev_axes], 2)
    n, k = boxes.shape[0], qboxes.shape[0]
    for i in range(n):
        for j in range(k):
            if rinc[i, j] <= 0:
                continue
            min_z = min(boxes[i, z_axis] + boxes[i, z_axis + 3] * (1 - z_center),
                        qboxes[j, z_axis] + qboxes[j, z_axis + 3] * (1 - z_center))
            max_z = max(boxes[i, z_axis] - boxes[i, z_axis + 3] * z_center,
                        qboxes[j, z_axis] - qboxes[j, z_axis + 3] * z_center)
            iw = min_z - max_z
            if iw > 0:
                area1 = boxes[i, 3] * boxes[i, 4] * boxes[i, 5]
                area2 = qboxes[j, 3] * qboxes[j, 4] * qboxes[j, 5]
                inc = iw * rinc[i, j]
                if criterion == -1:
                    ua = area1 + area2 - inc
                elif criterion == 0:
                    ua = area1
                elif criterion == 1:
                    ua = area2
                else:
                    ua = 1.0
                rinc[i, j] = inc / ua
            else:
                rinc[i, j] = 0.0
    return rinc


def calculate_ious(gt_annos, dt_annos, metric, z_axis=1, z_center=1.0):
    """Per-image overlap matrices [num_dt_i, num_gt_i] (dt rows, gt cols —
    matching the reference's calculate_iou_partly(dt, gt) argument order)."""
    overlaps = []
    bev_axes = list(range(3))
    bev_axes.pop(z_axis)
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            o = image_box_overlap(dt["bbox"], gt["bbox"])
        elif metric == 1:
            o = rotate_iou_eval(_bev_boxes(dt, bev_axes), _bev_boxes(gt, bev_axes))
        elif metric == 2:
            def full(a):
                return np.concatenate([a["location"], a["dimensions"],
                                       a["rotation_y"][..., None]], axis=1)
            o = d3_box_overlap(full(dt), full(gt), z_axis=z_axis, z_center=z_center)
        else:
            raise ValueError("unknown metric")
        overlaps.append(o.astype(np.float64))
    return overlaps


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Difficulty/ignore triage (eval.py:177-222)."""
    _class_names = ["car", "pedestrian", "cyclist", "van", "person_sitting",
                    "car", "tractor", "trailer"]
    _min_height = [40, 25, 25]
    _max_occlusion = [0, 1, 2]
    _max_truncation = [0.15, 0.3, 0.5]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = _class_names[current_class]
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        bbox = gt_anno["bbox"][i]
        gt_name = gt_anno["name"][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno["occluded"][i] > _max_occlusion[difficulty]
                  or gt_anno["truncated"][i] > _max_truncation[difficulty]
                  or height <= _min_height[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < _min_height[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt, dt, current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, dtype=np.int64))
        ignored_dets.append(np.array(ignored_det, dtype=np.int64))
        dontcares.append(np.stack(dc_bboxes, 0).astype(np.float64)
                         if dc_bboxes else np.zeros((0, 4)))
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate(
            [gt["bbox"], gt["alpha"][..., None]], 1))
        dt_datas_list.append(np.concatenate(
            [dt["bbox"], dt["alpha"][..., None], dt["score"][..., None]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
            total_num_valid_gt)


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Greedy TP/FP/FN matching for one image (eval.py:252-346).
    `overlaps` is [num_dt, num_gt]."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [dt_scores[i] < thresh if compute_fp else False
                         for i in range(det_size)]
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = _NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if (ignored_det[j] == -1 or assigned_detection[j]
                    or ignored_threshold[j]):
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap
                    and dt_score > valid_detection):
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == _NO_DETECTION and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == _NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != _NO_DETECTION
              and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned_detection[det_idx] = True
        elif valid_detection != _NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True

    if compute_fp:
        for i in range(det_size):
            if not (assigned_detection[i] or ignored_det[i] in (-1, 1)
                    or ignored_threshold[i]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes):
            overlaps_dt_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned_detection[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Score thresholds at ~uniform recall steps (eval.py:349-366)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def eval_class(gt_annos, dt_annos, current_classes, difficulties, metric,
               min_overlaps, compute_aos=False, z_axis=1, z_center=1.0):
    """(eval.py:396-468 without the partitioning layer)."""
    assert len(gt_annos) == len(dt_annos)
    overlaps = calculate_ious(gt_annos, dt_annos, metric, z_axis=z_axis,
                              z_center=z_center)
    n_sample_pts = 41
    num_min_overlap = len(min_overlaps)
    precision = np.zeros([len(current_classes), len(difficulties),
                          num_min_overlap, n_sample_pts])
    aos = np.zeros_like(precision)
    all_thresholds = np.zeros_like(precision)
    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficulties):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
             total_num_valid_gt) = _prepare_data(gt_annos, dt_annos,
                                                 current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    *_, th = compute_statistics(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i], metric,
                        min_overlap=min_overlap, thresh=0.0, compute_fp=False)
                    thresholdss += th.tolist()
                thresholds = np.array(get_thresholds(np.array(thresholdss),
                                                     total_num_valid_gt))
                all_thresholds[m, l, k, :len(thresholds)] = thresholds
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    for t, thresh in enumerate(thresholds):
                        tp, fp, fn, similarity, _ = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap, thresh=thresh,
                            compute_fp=True, compute_aos=compute_aos)
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if similarity != -1:
                            pr[t, 3] += similarity
                for i in range(len(thresholds)):
                    with np.errstate(invalid="ignore"):
                        precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                        if compute_aos:
                            aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:], axis=-1)
    return {"precision": precision, "orientation": aos,
            "thresholds": all_thresholds, "min_overlaps": min_overlaps}


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps, compute_aos=False,
            difficulties=(0, 1, 2), z_axis=1, z_center=1.0):
    types = ["bbox", "bev", "3d"]
    return {types[i]: eval_class(gt_annos, dt_annos, current_classes,
                                 difficulties, i, min_overlaps, compute_aos,
                                 z_axis=z_axis, z_center=z_center)
            for i in range(3)}


def _print_str(value, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, file=sstream)
    return sstream.getvalue()


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             difficulties=(0, 1, 2), z_axis=1, z_center=1.0):
    min_overlaps = np.array([[[0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.7, 0.7],
                              [0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.7, 0.7],
                              [0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.7, 0.7]]])
    class_to_name = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
                     4: "Person_sitting", 5: "car", 6: "tractor", 7: "trailer"}
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else c
                       for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]
    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break
    metrics = do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
                      compute_aos, difficulties, z_axis=z_axis, z_center=z_center)
    results_str = ""
    results = {}
    for j, cur_cls in enumerate(current_classes):
        name = class_to_name[cur_cls]
        map_bbox = get_map(metrics["bbox"]["precision"][j, :, 0])
        map_bev = get_map(metrics["bev"]["precision"][j, :, 0])
        map_3d = get_map(metrics["3d"]["precision"][j, :, 0])
        results_str += _print_str(
            f"{name} AP(Average Precision)"
            "@{:.2f}, {:.2f}, {:.2f}:".format(*min_overlaps[0, :, j]))
        results_str += _print_str(
            "bbox AP:" + ", ".join(f"{v:.2f}" for v in map_bbox))
        results_str += _print_str(
            "bev  AP:" + ", ".join(f"{v:.2f}" for v in map_bev))
        results_str += _print_str(
            "3d   AP:" + ", ".join(f"{v:.2f}" for v in map_3d))
        if compute_aos:
            map_aos = get_map(metrics["bbox"]["orientation"][j, :, 0])
            results_str += _print_str(
                "aos  AP:" + ", ".join(f"{v:.2f}" for v in map_aos))
        results[name] = {"bbox": map_bbox, "bev": map_bev, "3d": map_3d}
    return metrics, results, results_str

"""The voting evaluators' vote reduction (counterpart of pvcnn_tpu/native
vote_reduce_max; reference evaluate/shapenet/eval.py:176-185 and
evaluate/s3dis/eval.py:188-203): each point keeps the prediction of its
most confident vote, and a vote replaces the kept one only if strictly
more confident, so the first of equal votes wins, across calls too.

vote_reduce_max runs the host library's one pass over the votes
(native/ptio.cpp); vote_reduce_max_plain is its plain version, a three-key
lexsort, exact too, which the tests and chip_smoke.py hold it against."""

from __future__ import annotations

import numpy as np

from pvcnn_tpu_torch.native import vote_reduce_max

__all__ = ["vote_reduce_max", "vote_reduce_max_plain"]


def vote_reduce_max_plain(vote_confidences, vote_predictions, point_indices,
                          confidences, predictions) -> None:
    """vote_reduce_max by sorting: each point's first most confident vote,
    kept where it beats the point's kept confidence."""
    votes = np.arange(len(vote_confidences))
    order = np.lexsort((votes, -vote_confidences, point_indices))
    points = point_indices[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = points[1:] != points[:-1]
    best, points = order[first], points[first]
    better = vote_confidences[best] > confidences[points]
    confidences[points[better]] = vote_confidences[best[better]]
    predictions[points[better]] = vote_predictions[best[better]]

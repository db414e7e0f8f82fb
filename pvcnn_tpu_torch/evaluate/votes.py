"""The voting evaluators' vote reduction (counterpart of pvcnn_tpu/native
vote_reduce_max; reference evaluate/shapenet/eval.py:176-185 and
evaluate/s3dis/eval.py:188-203): each point keeps the prediction of its
most confident vote, and a vote replaces the kept one only if strictly
more confident, so the first of equal votes wins, across calls too."""

from __future__ import annotations

import numpy as np

__all__ = ["vote_reduce_max"]


def vote_reduce_max(vote_confidences, vote_predictions, point_indices,
                    confidences, predictions) -> None:
    """Fold the votes (confidence, prediction, point index; flat arrays)
    into the points' kept confidences and predictions, in place."""
    votes = np.arange(len(vote_confidences))
    order = np.lexsort((votes, -vote_confidences, point_indices))
    points = point_indices[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = points[1:] != points[:-1]
    best, points = order[first], points[first]
    better = vote_confidences[best] > confidences[points]
    confidences[points[better]] = vote_confidences[best[better]]
    predictions[points[better]] = vote_predictions[best[better]]

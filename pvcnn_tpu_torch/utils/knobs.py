"""The switches that open the port's opt-in paths, under the JAX package's
environment-variable names, defaults and choices (its registry is
pvcnn_tpu/utils/knobs.py), so one variable switches both packages.

    PVCNN_TPU_CONV_ROWS          auto | 0   (auto)  0: the PVConv voxel branch
                                 runs on NDHWC grids [B, R, R, R, C] instead
                                 of flat rows [B, C, R^3] (K3/K4)
    PVCNN_TPU_CONV_BN_FUSED      auto | 0   (auto)  0: on the rows branch,
                                 each conv runs K3 without its prologue and
                                 statistics, and each BatchNorm and
                                 LeakyReLU is a pass of its own over
                                 [B, C, R^3] (CONV_ROWS=0 takes precedence)
    PVCNN_TPU_DENSE_BN_FUSED     auto | 0   (0)     auto: train-mode SharedMLP
                                 layers run Dense + BN statistics in one
                                 kernel (ops/dense_rows.py, K9/K10)
    PVCNN_TPU_CUSTOM_CONV_WGRAD  0 | 1      (0)     1: the NDHWC conv's
                                 weight gradient runs K11
                                 (ops/conv3d.py:conv3d_same)

Values are read each time a forward asks (not cached at import); a value
outside the choices raises ValueError naming the variable.
"""

from __future__ import annotations

import os

__all__ = ["KNOBS", "get"]

# name -> (choices, default); a bool knob's choices are "0" and "1"
KNOBS = {
    "PVCNN_TPU_CONV_ROWS": (("auto", "0"), "auto"),
    "PVCNN_TPU_CONV_BN_FUSED": (("auto", "0"), "auto"),
    "PVCNN_TPU_DENSE_BN_FUSED": (("auto", "0"), "0"),
    "PVCNN_TPU_CUSTOM_CONV_WGRAD": (("0", "1"), "0"),
}
_BOOL = {"PVCNN_TPU_CUSTOM_CONV_WGRAD"}


def get(name: str):
    """The knob's value: its choice string, or a bool for a 0/1 knob. Unset
    or empty gives the default. Raises KeyError for an unknown name."""
    choices, default = KNOBS[name]
    raw = os.environ.get(name) or default
    if raw not in choices:
        raise ValueError(f"{name} must be one of {', '.join(choices)}, got "
                         f"{raw!r}")
    return raw == "1" if name in _BOOL else raw

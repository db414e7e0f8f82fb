"""Architecture builders (counterpart of pvcnn_tpu/models/utils.py, the parts
the PVConv models use). Unlike flax, torch modules need their input widths,
so the builders thread `in_channels` through, as the reference does.
Dropout is encoded in channel lists as floats < 1, as in the reference."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from pvcnn_tpu_torch.nn import PVConv, SharedMLP, SplitDense

__all__ = ["Dropout", "apply_layers", "create_mlp_components",
           "create_pointnet_components", "set_dropout_generator"]


class Dropout(nn.Dropout):
    """Dropout whose mask is drawn from `self.generator`, a torch.Generator
    on the input's device that the trainer owns (the counterpart of the JAX
    trainer's explicit dropout key); None draws from torch's default
    generator. Holds no parameters, so state_dict keys do not change."""

    generator: torch.Generator | None = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep


def set_dropout_generator(model: nn.Module, generator: torch.Generator):
    """Make every Dropout of `model` draw from `generator`."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


def apply_layers(layers, x):
    """Run a builder-produced layer list in order on [B, N, C] features."""
    for layer in layers:
        x = layer(x)
    return x


def create_mlp_components(in_channels: int, out_channels: Sequence,
                          classifier: bool = False,
                          width_multiplier: float = 1):
    """Per-point MLP -> (layers, out channels). With classifier=True the last
    entry is a plain 1x1 conv (the reference's Conv1d) of that many outputs."""
    r = width_multiplier
    out_channels = list(out_channels)
    layers = []
    for oc in out_channels[:-1]:
        if oc < 1:
            layers.append(Dropout(oc))
        else:
            oc = int(r * oc)
            layers.append(SharedMLP(in_channels, oc))
            in_channels = oc
    if classifier:
        layers.append(SplitDense(in_channels, int(out_channels[-1])))
        return layers, int(out_channels[-1])
    oc = int(r * out_channels[-1])
    layers.append(SharedMLP(in_channels, oc))
    return layers, oc


def create_pointnet_components(blocks, in_channels: int,
                               with_se: bool = False, normalize: bool = True,
                               eps: float = 0.0, width_multiplier: float = 1,
                               voxel_resolution_multiplier: float = 1):
    """blocks: ((out_channels, num_blocks, voxel_resolution | None), ...) ->
    (layers, out channels, concat channels): PVConv where a resolution is
    given, SharedMLP otherwise."""
    r, vr = width_multiplier, voxel_resolution_multiplier
    layers, concat_channels = [], 0
    for out_channels, num_blocks, voxel_resolution in blocks:
        out_channels = int(r * out_channels)
        for _ in range(num_blocks):
            if voxel_resolution is None:
                layers.append(SharedMLP(in_channels, out_channels))
            else:
                layers.append(PVConv(in_channels, out_channels, kernel_size=3,
                                     resolution=int(vr * voxel_resolution),
                                     with_se=with_se, normalize=normalize,
                                     eps=eps))
            in_channels = out_channels
            concat_channels += out_channels
    return layers, in_channels, concat_channels

"""Architecture builders (counterpart of pvcnn_tpu/models/utils.py, the parts
the PVConv and PointNet++ models use). Unlike flax, torch modules need their input widths,
so the builders thread `in_channels` through, as the reference does.
Dropout is encoded in channel lists as floats < 1, as in the reference."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from pvcnn_tpu_torch.nn import (DenseBNReLU, PointNetAModule,
                                PointNetFPModule, PointNetSAModule, PVConv,
                                SharedMLP, SplitDense)
from pvcnn_tpu_torch.nn.shared_mlp import Linear

__all__ = ["Dropout", "apply_layers", "create_mlp_components",
           "create_pointnet2_fp_modules", "create_pointnet2_sa_components",
           "create_pointnet_components", "set_dropout_generator",
           "set_sample_generator"]


class Dropout(nn.Dropout):
    """Dropout whose mask is drawn from `self.generator`, a torch.Generator
    on the input's device that the trainer owns (the counterpart of the JAX
    trainer's explicit dropout key); None draws from torch's default
    generator. Holds no parameters, so state_dict keys do not change. A
    bf16 input's mask is drawn in float32, so a bf16 model draws the masks
    its fp32 twin draws from the same generator state (JAX's masks do not
    depend on the dtype either)."""

    generator: torch.Generator | None = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(
            x, dtype=torch.promote_types(x.dtype, torch.float32)).bernoulli_(
                keep, generator=self.generator).to(x.dtype)
        return x * mask / keep


def set_dropout_generator(model: nn.Module, generator: torch.Generator):
    """Make every Dropout of `model` draw from `generator`."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


def set_sample_generator(model: nn.Module, generator: torch.Generator):
    """Make every module of `model` that samples (one with a
    `sample_generator` attribute: the Frustum models' foreground sampler)
    draw from `generator`."""
    for mod in model.modules():
        if hasattr(mod, "sample_generator"):
            mod.sample_generator = generator


def apply_layers(layers, x):
    """Run a builder-produced layer list in order on [B, N, C] features."""
    for layer in layers:
        x = layer(x)
    return x


def create_mlp_components(in_channels: int, out_channels: Sequence,
                          classifier: bool = False, dim: int = 2,
                          width_multiplier: float = 1, dtype=None):
    """MLP -> (layers, out channels). dim=2: per-point SharedMLP layers on
    [B, N, C]; dim=1: per-cloud DenseBNReLU layers on [B, C]. With
    classifier=True the last entry is a plain layer of that many outputs
    (the reference's Conv1d, or Linear with dim=1). dtype: every layer's
    activation dtype (nn/shared_mlp.py)."""
    if dim not in (1, 2):
        raise ValueError(f"create_mlp_components dim must be 1 or 2, got "
                         f"{dim}")
    block = DenseBNReLU if dim == 1 else SharedMLP
    r = width_multiplier
    out_channels = list(out_channels)
    layers = []
    for oc in out_channels[:-1]:
        if oc < 1:
            layers.append(Dropout(oc))
        else:
            oc = int(r * oc)
            layers.append(block(in_channels, oc, dtype=dtype))
            in_channels = oc
    if classifier:
        last = Linear if dim == 1 else SplitDense
        layers.append(last(in_channels, int(out_channels[-1]), dtype=dtype))
        return layers, int(out_channels[-1])
    oc = int(r * out_channels[-1])
    layers.append(block(in_channels, oc, dtype=dtype))
    return layers, oc


def create_pointnet_components(blocks, in_channels: int,
                               with_se: bool = False, normalize: bool = True,
                               eps: float = 0.0, width_multiplier: float = 1,
                               voxel_resolution_multiplier: float = 1,
                               dtype=None):
    """blocks: ((out_channels, num_blocks, voxel_resolution | None), ...) ->
    (layers, out channels, concat channels): PVConv where a resolution is
    given, SharedMLP otherwise, each with activation dtype `dtype`."""
    layers, concat_channels = [], 0
    for conv_configs in blocks:
        group, in_channels = _conv_blocks(
            conv_configs, in_channels, with_se, normalize, eps,
            width_multiplier, voxel_resolution_multiplier, dtype)
        layers += group
        concat_channels += len(group) * in_channels
    return layers, in_channels, concat_channels


def _conv_blocks(conv_configs, in_channels: int, with_se, normalize, eps,
                 r, vr, dtype=None):
    """(out_channels, num_blocks, voxel_resolution | None) -> (PVConv or
    SharedMLP layers, out channels)."""
    out_channels, num_blocks, voxel_resolution = conv_configs
    out_channels = int(r * out_channels)
    layers = []
    for _ in range(num_blocks):
        if voxel_resolution is None:
            layers.append(SharedMLP(in_channels, out_channels, dtype=dtype))
        else:
            layers.append(PVConv(in_channels, out_channels, kernel_size=3,
                                 resolution=int(vr * voxel_resolution),
                                 with_se=with_se, normalize=normalize,
                                 eps=eps, dtype=dtype))
        in_channels = out_channels
    return layers, in_channels


def _group(layers):
    """A layer group as the reference holds it: the module itself, or an
    nn.Sequential of its members (the state_dict prefix then gains the
    member's index)."""
    return layers[0] if len(layers) == 1 else nn.Sequential(*layers)


def create_pointnet2_sa_components(sa_blocks, extra_feature_channels: int,
                                   with_se: bool = False,
                                   normalize: bool = True, eps: float = 0.0,
                                   width_multiplier: float = 1,
                                   voxel_resolution_multiplier: float = 1,
                                   dtype=None):
    """sa_blocks: ((conv_configs | None, sa_configs), ...) with sa_configs =
    (num_centers, radius, num_neighbors, out_channels) -> (sa_layers,
    sa_in_channels, out channels, num_centers). Each entry of sa_layers is
    a group: optional PVConv/SharedMLP blocks, then one PointNetSAModule (or
    PointNetAModule when num_centers is None), each with activation dtype
    `dtype`.

    A set-abstraction module takes the group's features without the
    coordinates (it appends the 3 relative ones itself): the extra feature
    channels, or the conv blocks' output width where the group has conv
    blocks. `sa_in_channels` holds each group's input width with the
    coordinates, for the feature-propagation skips."""
    r, vr = width_multiplier, voxel_resolution_multiplier
    in_channels = extra_feature_channels + 3
    sa_layers, sa_in_channels = [], []
    num_centers = None
    for conv_configs, sa_configs in sa_blocks:
        sa_in_channels.append(in_channels)
        group = []
        if conv_configs is not None:
            group, in_channels = _conv_blocks(conv_configs, in_channels,
                                              with_se, normalize, eps, r, vr,
                                              dtype)
            extra_feature_channels = in_channels
        num_centers, radius, num_neighbors, out_channels = sa_configs
        out_channels = [[int(r * c) for c in oc]
                        if isinstance(oc, (list, tuple)) else int(r * oc)
                        for oc in out_channels]
        if num_centers is None:
            sa = PointNetAModule(extra_feature_channels, out_channels,
                                 dtype=dtype)
        else:
            sa = PointNetSAModule(num_centers, radius, num_neighbors,
                                  extra_feature_channels, out_channels,
                                  dtype=dtype)
        group.append(sa)
        in_channels = extra_feature_channels = sa.out_channels
        sa_layers.append(_group(group))
    return sa_layers, sa_in_channels, in_channels, (
        1 if num_centers is None else num_centers)


def create_pointnet2_fp_modules(fp_blocks, in_channels: int,
                                sa_in_channels, with_se: bool = False,
                                normalize: bool = True, eps: float = 0.0,
                                width_multiplier: float = 1,
                                voxel_resolution_multiplier: float = 1,
                                dtype=None):
    """fp_blocks: ((fp_mlp_channels, conv_configs | None), ...) -> (fp_layers,
    out channels). Group i starts with a PointNetFPModule whose skip
    features come from sa_in_channels[-1 - i]; every module has activation
    dtype `dtype`."""
    r, vr = width_multiplier, voxel_resolution_multiplier
    fp_layers = []
    for fp_idx, (fp_configs, conv_configs) in enumerate(fp_blocks):
        out_channels = [int(r * oc) for oc in fp_configs]
        group = [PointNetFPModule(in_channels + sa_in_channels[-1 - fp_idx],
                                  out_channels, dtype=dtype)]
        in_channels = out_channels[-1]
        if conv_configs is not None:
            blocks, in_channels = _conv_blocks(conv_configs, in_channels,
                                               with_se, normalize, eps, r, vr,
                                               dtype)
            group += blocks
        fp_layers.append(_group(group))
    return fp_layers, in_channels

"""Weights for the port: the JAX package's variables moved into a port
`state_dict`, and seeded random weights.

`state_dict_from_jax` is the inverse of
pvcnn_tpu/utils/checkpoint_import.py:import_state_dict. It walks the same
(torch_prefix, flax_path, kind) mapping (e.g. `pvcnn_shapenet_mapping()`)
and undoes its transposes:

    Dense kernel [in, out]           -> Conv1d weight [out, in, 1] /
                                        Conv2d [out, in, 1, 1] / Linear [out, in]
    Conv kernel  [k, k, k, in, out]  -> Conv3d weight [out, in, k, k, k]
    BatchNorm scale/bias, batch_stats mean/var
                                     -> weight/bias, running_mean/running_var

The mapping module imports only numpy, so this file never imports jax.
A model with bf16 activations (ShapeNet PVCNN's dtype="bfloat16") holds
float32 parameters and statistics, as the JAX model does in either dtype,
so the same variables carry over unchanged.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn as nn

__all__ = ["init_random_", "load_reference_checkpoint",
           "state_dict_from_jax"]


def _leaf(tree: dict, path: str, leaf: str) -> np.ndarray:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node[leaf])


def state_dict_from_jax(params: dict, batch_stats: dict,
                        mapping: Iterable[Tuple[str, str, str]],
                        template: Dict[str, torch.Tensor]):
    """JAX variables (nested dicts of arrays) -> a port state_dict.

    `template` is the port model's own `state_dict()`: it gives each
    tensor's shape and dtype and supplies the entries the mapping does not
    cover (BatchNorm's num_batches_tracked). Raises KeyError when the mapping
    names a key the template lacks."""
    out = dict(template)

    def put(key: str, value: np.ndarray):
        want = template[key]
        out[key] = torch.from_numpy(np.ascontiguousarray(value)).reshape(
            want.shape).to(want.dtype)

    for torch_prefix, flax_path, kind in mapping:
        if kind == "dense":
            put(f"{torch_prefix}.weight", _leaf(params, flax_path, "kernel").T)
            if f"{torch_prefix}.bias" in template:
                put(f"{torch_prefix}.bias", _leaf(params, flax_path, "bias"))
        elif kind == "conv3d":
            kernel = _leaf(params, flax_path, "kernel")
            put(f"{torch_prefix}.weight", np.transpose(kernel, (4, 3, 0, 1, 2)))
            put(f"{torch_prefix}.bias", _leaf(params, flax_path, "bias"))
        elif kind == "bn":
            put(f"{torch_prefix}.weight", _leaf(params, flax_path, "scale"))
            put(f"{torch_prefix}.bias", _leaf(params, flax_path, "bias"))
            put(f"{torch_prefix}.running_mean",
                _leaf(batch_stats, flax_path, "mean"))
            put(f"{torch_prefix}.running_var",
                _leaf(batch_stats, flax_path, "var"))
        else:
            raise ValueError(f"unknown mapping kind {kind!r}")
    return out


def load_reference_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load a reference `.pth.tar` (its `model` entry, or the file itself
    when it is a bare state dict; a DataParallel `module.` prefix is
    dropped). The port's module names are the reference's, so the keys load
    as they are. The file is unpickled: load only trusted files."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=False)
    state = checkpoint.get("model", checkpoint)
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}
    model.load_state_dict(state)
    return model


@torch.no_grad()
def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter and BatchNorm statistic from one seeded
    torch.Generator, in module order, on the CPU (so a seed gives the same
    weights on any device).

    Weights and biases follow torch's default layer init (uniform in
    +-1/sqrt(fan_in)); BatchNorm gets scale in [0.6, 1.4], bias N(0, 0.1),
    running mean N(0, 0.2) and running variance in [0.6, 1.4], so every
    statistic takes part in the forward."""
    gen = torch.Generator().manual_seed(int(seed))

    def draw(t: torch.Tensor, fill):
        cpu = torch.empty(t.shape, dtype=t.dtype)
        fill(cpu)
        t.copy_(cpu)

    for mod in model.modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            draw(mod.weight, lambda t: t.uniform_(0.6, 1.4, generator=gen))
            draw(mod.bias, lambda t: t.normal_(0.0, 0.1, generator=gen))
            draw(mod.running_mean,
                 lambda t: t.normal_(0.0, 0.2, generator=gen))
            draw(mod.running_var,
                 lambda t: t.uniform_(0.6, 1.4, generator=gen))
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d,
                              nn.Linear)):
            fan_in = mod.weight[0].numel()
            bound = 1.0 / fan_in ** 0.5
            draw(mod.weight,
                 lambda t: t.uniform_(-bound, bound, generator=gen))
            if mod.bias is not None:
                draw(mod.bias,
                     lambda t: t.uniform_(-bound, bound, generator=gen))
    return model

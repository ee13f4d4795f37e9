"""Weight carriers (counterpart of `train/checkpoints.py`, inference only).

`params_from_jax` takes the JAX package's flax `params` tree with numpy
leaves and returns the port's `state_dict`; `init_weights` draws weights
from an explicit `torch.Generator` the way flax initializes them
(LeCun-normal kernels, zero biases, the reference's tiny coord output).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ..models.pose_head import RegistrationModel


def _dense(prefix: str, leaf: Mapping[str, Any]) -> dict:
    out = {f"{prefix}.weight": np.asarray(leaf["kernel"]).T}   # [in,out] → [out,in]
    if "bias" in leaf:
        out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
    return out


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax params (`{'params': {'egnn': ..., 'mlp': ...}}` or the inner
    dict) → the port's RegistrationModel state_dict (float32 tensors)."""
    tree = tree["params"] if "params" in tree else tree
    sd: dict = {}
    egnn = tree["egnn"]
    sd.update(_dense("egnn.embedding_in", egnn["embedding_in"]))
    sd.update(_dense("egnn.embedding_out", egnn["embedding_out"]))
    for name, gcl in egnn.items():
        if not name.startswith("gcl_"):
            continue
        p = f"egnn.{name}"
        em = gcl["edge_mlp"]
        sd.update(_dense(f"{p}.edge_mlp.fused_in", em["fused_in"]))
        sd[f"{p}.edge_mlp.head_kernels"] = np.asarray(em["head_kernels"])
        sd[f"{p}.edge_mlp.head_biases"] = np.asarray(em["head_biases"])
        sd[f"{p}.layer_norm.weight"] = np.asarray(gcl["layer_norm"]["scale"])
        sd[f"{p}.layer_norm.bias"] = np.asarray(gcl["layer_norm"]["bias"])
        for sub in ("coord_mlp_0", "coord_mlp_out", "node_mlp_0", "node_mlp_1"):
            sd.update(_dense(f"{p}.{sub}", gcl[sub]))
    for name, leaf in tree["mlp"].items():
        sd.update(_dense(f"mlp.{name}", leaf))
    return {k: torch.tensor(np.array(v, dtype=np.float32)) for k, v in sd.items()}


@torch.no_grad()
def init_weights(model: RegistrationModel, generator: torch.Generator) -> None:
    """Seeded random weights: LeCun-normal Dense kernels, zero biases, unit
    LayerNorm, and the coord output at xavier-uniform with gain 1e-3."""
    def draw(shape, std):
        return torch.randn(shape, generator=generator) * std

    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            fan_out, fan_in = mod.weight.shape
            if name.endswith("coord_mlp_out"):
                lim = 1e-3 * (6.0 / (fan_in + fan_out)) ** 0.5
                w = (torch.rand(mod.weight.shape, generator=generator) * 2 - 1) * lim
            else:
                w = draw(mod.weight.shape, fan_in ** -0.5)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif hasattr(mod, "head_kernels"):
            hk = mod.head_kernels
            hk.copy_(draw(hk.shape, hk.shape[-2] ** -0.5))
            mod.head_biases.zero_()

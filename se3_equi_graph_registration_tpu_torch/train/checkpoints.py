"""Weights in and out (counterpart of `train/checkpoints.py`).

- `convert_reference_checkpoint` / `convert_reference_egnn`: a reference
  `.pth` (`{epoch, egnn_state_dict, cross_attention_state_dict,
  optimizer_state_dict}`) → the port's state_dict. The reference's per-head
  edge MLPs fuse into one input layer and a stack of head kernels, stored
  as flax keeps them ([in, out]); its Linear weights stay [out, in]; the
  unused auxiliary modules (shared_mlp_decoder, shallow_mlp_pose, bn1/bn2)
  are dropped. The reference's format has no PointNet weights, so a
  checkpoint converts to a model without the encoder;
- `export_reference_checkpoint`: the inverse, a `.pth` the reference loads
  with strict state_dicts, auxiliary modules drawn from a numpy seed as the
  JAX package draws them, and a fresh Adam state;
- `TrainCheckpointer`: a directory of `step_<n>.pt` files (model,
  optimizer, with bf16 parameters the fp32 masters and the rounding
  generator's state, schedule, step) with retention and resume, for `fit`;
- `params_from_jax` takes the JAX package's flax `params` tree with numpy
  leaves (bf16 leaves of a `bf16_params` state keep their dtype);
  `dense_params_from_jax` takes any flax tree whose leaves are `Dense`
  layers (the model zoo's `models/variants.py`); `init_weights` draws
  weights from an explicit `torch.Generator` the way flax initializes them
  (LeCun-normal kernels, zero biases, the reference's tiny coord output).
"""
from __future__ import annotations

import os
import re
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..models.pose_head import RegistrationModel

# the reference's trained EGNN (the shapes of its shipped checkpoints)
REFERENCE_EGNN_CONFIG = dict(
    in_node_nf=32, hidden_nf=32, out_node_nf=32, edge_attr_dim=1,
    n_layers=3, num_heads=4,
)
MLP_LAYERS = (("dense_0", 0), ("dense_1", 2), ("dense_2", 4))   # port name, reference index


def _load_pth(path: str) -> dict:
    """The checkpoint dict at `path`. `weights_only=False`, as the JAX
    package loads it: the JAX exporter writes numpy-backed tensors and the
    reference's files carry their optimizer's Python objects; load only
    files you trust (unpickling can run code)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _egnn_from_reference(sd: Mapping[str, Any], prefix: str, n_layers: int,
                         num_heads: int, hidden: int) -> dict:
    """A reference EGNN state_dict (keys under `prefix`) → the port's EGNN
    names (no prefix), float32 numpy."""
    g = lambda k: np.asarray(sd[prefix + k], dtype=np.float32)
    out = {f"{m}.{p}": g(f"{m}.{p}") for m in ("embedding_in", "embedding_out")
           for p in ("weight", "bias")}
    w = hidden // num_heads
    for i in range(n_layers):
        p = f"gcl_{i}."
        heads = range(num_heads)
        out[p + "edge_mlp.fused_in.weight"] = np.concatenate(
            [g(p + f"edge_mlps.{h}.0.weight") for h in heads], axis=0)
        out[p + "edge_mlp.fused_in.bias"] = np.concatenate(
            [g(p + f"edge_mlps.{h}.0.bias") for h in heads], axis=0)
        hk = np.stack([g(p + f"edge_mlps.{h}.2.weight").T for h in heads], axis=0)
        if hk.shape != (num_heads, w, w):
            raise ValueError(f"gcl_{i}: head kernels {hk.shape}, want {(num_heads, w, w)}")
        out[p + "edge_mlp.head_kernels"] = hk
        out[p + "edge_mlp.head_biases"] = np.stack(
            [g(p + f"edge_mlps.{h}.2.bias") for h in heads], axis=0)
        for a, b in (("layer_norm", "layer_norm"), ("node_mlp_0", "node_mlp.0"),
                     ("node_mlp_1", "node_mlp.2"), ("coord_mlp_0", "coord_mlp.0")):
            out[f"{p}{a}.weight"] = g(f"{p}{b}.weight")
            out[f"{p}{a}.bias"] = g(f"{p}{b}.bias")
        out[p + "coord_mlp_out.weight"] = g(p + "coord_mlp.2.weight")
    return out


def _tensors(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def convert_reference_checkpoint(path: str, n_layers: int = 3, num_heads: int = 4,
                                 hidden: int = 32) -> dict[str, torch.Tensor]:
    """The port's RegistrationModel state_dict from a reference `.pth`: its
    `cross_attention_state_dict` holds the shared EGNN (under `egnn.`) and
    the score MLP (`mlp.0/2/4`)."""
    ca = _load_pth(path)["cross_attention_state_dict"]
    sd = {f"egnn.{k}": v for k, v in
          _egnn_from_reference(ca, "egnn.", n_layers, num_heads, hidden).items()}
    for name, i in MLP_LAYERS:
        for p in ("weight", "bias"):
            sd[f"mlp.{name}.{p}"] = np.asarray(ca[f"mlp.{i}.{p}"], dtype=np.float32)
    return _tensors(sd)


def convert_reference_egnn(path: str, n_layers: int = 3, num_heads: int = 4,
                           hidden: int = 32) -> dict[str, torch.Tensor]:
    """A bare EGNN's state_dict from the checkpoint's standalone
    `egnn_state_dict` (a copy of the shared EGNN's weights)."""
    return _tensors(_egnn_from_reference(_load_pth(path)["egnn_state_dict"], "",
                                         n_layers, num_heads, hidden))


def _egnn_to_reference(sd: Mapping[str, torch.Tensor], prefix: str, n_layers: int,
                       num_heads: int, hidden: int) -> dict:
    """Inverse of `_egnn_from_reference`: the port's EGNN weights (keys
    under `egnn.`) → reference names under `prefix`, float32 numpy."""
    g = lambda k: sd["egnn." + k].detach().cpu().float().numpy()
    out = {f"{prefix}{m}.{p}": g(f"{m}.{p}") for m in ("embedding_in", "embedding_out")
           for p in ("weight", "bias")}
    w = hidden // num_heads
    for i in range(n_layers):
        q, p = f"gcl_{i}.", f"{prefix}gcl_{i}."
        fused_w, fused_b = g(q + "edge_mlp.fused_in.weight"), g(q + "edge_mlp.fused_in.bias")
        hk, hb = g(q + "edge_mlp.head_kernels"), g(q + "edge_mlp.head_biases")
        for h in range(num_heads):
            out[p + f"edge_mlps.{h}.0.weight"] = fused_w[h * w:(h + 1) * w]
            out[p + f"edge_mlps.{h}.0.bias"] = fused_b[h * w:(h + 1) * w]
            out[p + f"edge_mlps.{h}.2.weight"] = hk[h].T
            out[p + f"edge_mlps.{h}.2.bias"] = hb[h]
        for a, b in (("layer_norm", "layer_norm"), ("node_mlp_0", "node_mlp.0"),
                     ("node_mlp_1", "node_mlp.2"), ("coord_mlp_0", "coord_mlp.0")):
            out[f"{p}{b}.weight"] = g(f"{q}{a}.weight")
            out[f"{p}{b}.bias"] = g(f"{q}{a}.bias")
        out[p + "coord_mlp.2.weight"] = g(q + "coord_mlp_out.weight")
    return out


def export_reference_checkpoint(state_dict: Mapping[str, torch.Tensor], path: str,
                                epoch: int = 0, lr: float = 1e-4, n_layers: int = 3,
                                num_heads: int = 4, hidden: int = 32, seed: int = 0) -> None:
    """Write the port's weights as a reference `.pth`: {epoch,
    egnn_state_dict, cross_attention_state_dict, optimizer_state_dict}, the
    inverse of `convert_reference_checkpoint`. The head's auxiliary modules,
    present in every reference checkpoint and unused by its forward pass,
    take the reference's initialization: Linear layers U(±1/√fan_in) drawn
    by `np.random.default_rng(seed)` in the JAX exporter's order (so the
    two exporters write equal tensors for equal weights and seed), BatchNorm
    at identity. The optimizer entry is a fresh Adam state over the head's
    parameter list. Every tensor is written fp32, bf16 weights too (the
    reference's schema is fp32). The PointNet encoder's weights
    (`pointnet.*`) are not written: the reference's schema has no place for
    them, and the JAX exporter drops them too."""
    egnn_sd = _egnn_to_reference(state_dict, "", n_layers, num_heads, hidden)
    ca = _egnn_to_reference(state_dict, "egnn.", n_layers, num_heads, hidden)
    for name, i in MLP_LAYERS:
        for p in ("weight", "bias"):
            ca[f"mlp.{i}.{p}"] = state_dict[f"mlp.{name}.{p}"].detach().cpu().float().numpy()
    rng = np.random.default_rng(seed)

    def linear(pfx: str, fan_in: int, fan_out: int):
        bound = 1.0 / np.sqrt(fan_in)
        ca[pfx + ".weight"] = rng.uniform(-bound, bound, (fan_out, fan_in)).astype(np.float32)
        ca[pfx + ".bias"] = rng.uniform(-bound, bound, (fan_out,)).astype(np.float32)

    linear("shared_mlp_decoder.0", (hidden + 3) * 2, 128)
    linear("shared_mlp_decoder.2", 128, 64)
    linear("shallow_mlp_pose.0", 64, 32)
    linear("shallow_mlp_pose.2", 32, 7)
    for bn, dim in (("bn1", hidden), ("bn2", hidden + 3)):
        ca[bn + ".weight"] = np.ones(dim, np.float32)
        ca[bn + ".bias"] = np.zeros(dim, np.float32)
        ca[bn + ".running_mean"] = np.zeros(dim, np.float32)
        ca[bn + ".running_var"] = np.ones(dim, np.float32)
        ca[bn + ".num_batches_tracked"] = np.asarray(0, np.int64)
    to_torch = lambda d: {k: torch.from_numpy(np.array(v, copy=True)) for k, v in d.items()}
    n_params = sum(1 for k in ca if not k.endswith(("running_mean", "running_var",
                                                    "num_batches_tracked")))
    torch.save({
        "epoch": int(epoch),
        "egnn_state_dict": to_torch(egnn_sd),
        "cross_attention_state_dict": to_torch(ca),
        "optimizer_state_dict": {
            "state": {},
            "param_groups": [{
                "lr": lr, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0,
                "amsgrad": False, "maximize": False, "foreach": None, "capturable": False,
                "differentiable": False, "fused": None, "params": list(range(n_params)),
            }],
        },
    }, path)


def _optimizer(state):
    """What a checkpoint holds of the optimizer: with bf16 parameters the
    wrapper (Adam, the fp32 masters, the rounding generator), else Adam."""
    return state.optimizer.sr if state.optimizer.sr is not None else state.optimizer.adam


class TrainCheckpointer:
    """A directory of `step_<n>.pt` checkpoints of a training state (the
    model's and the optimizer's state_dicts, the schedule's, the step, and
    any metrics), keeping the newest `keep`. `save` skips a step at or
    below the newest one saved, as the JAX package's orbax manager does, so
    fit's best-val and periodic saves of one step write once;
    `restore_latest(template)` loads the newest into the template (a
    `engine.TrainState`) and returns (template, step), or None when the
    directory holds none. Files load with `weights_only=True`."""

    def __init__(self, directory: str, keep: int = 5):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        """The saved steps, ascending."""
        found = (re.fullmatch(r"step_(\d+)\.pt", f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state, metrics: Optional[dict] = None) -> bool:
        """Write `state` at `step` (False, and nothing written, if a step at
        or above it is saved already); then drop all but the newest `keep`."""
        steps = self.steps()
        if steps and steps[-1] >= step:
            return False
        payload = {"model": state.model.state_dict(),
                   "optimizer": _optimizer(state).state_dict(),
                   "schedule": state.optimizer.schedule.state_dict(),
                   "step": int(state.step), "metrics": dict(metrics or {})}
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))       # a reader never sees half a file
        for old in (steps + [step])[:-self.keep]:
            os.remove(self._path(old))
        return True

    def restore_latest(self, template) -> Optional[tuple[Any, int]]:
        steps = self.steps()
        if not steps:
            return None
        dev = next(template.model.parameters()).device
        ck = torch.load(self._path(steps[-1]), map_location=dev, weights_only=True)
        template.model.load_state_dict(ck["model"])
        _optimizer(template).load_state_dict(ck["optimizer"])
        template.optimizer.schedule.load_state_dict(ck["schedule"])
        template.step = ck["step"]
        return template, steps[-1]


def _dense(prefix: str, leaf: Mapping[str, Any]) -> dict:
    out = {f"{prefix}.weight": np.asarray(leaf["kernel"]).T}   # [in,out] → [out,in]
    if "bias" in leaf:
        out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
    return out


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax params (`{'params': {'egnn': ..., 'mlp': ...}}` or the inner
    dict, with a `pointnet` subtree for a PointNet model) → the port's
    RegistrationModel state_dict: float32 tensors, bfloat16 for the
    `ml_dtypes` bf16 leaves of a `bf16_params` state."""
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
    for conv, leaves in tree.get("pointnet", {}).items():
        if conv == "classifier":
            sd.update(_dense("pointnet.classifier", leaves))
        else:
            for name, leaf in leaves.items():
                sd.update(_dense(f"pointnet.{conv}.{name}", leaf))
    return {k: _tensor(v) for k, v in sd.items()}


def _dense_tree(tree: Mapping[str, Any], prefix: str) -> dict:
    sd: dict = {}
    for name, leaf in tree.items():
        sd.update(_dense(prefix + name, leaf) if "kernel" in leaf
                  else _dense_tree(leaf, f"{prefix}{name}."))
    return sd


def dense_params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax `params` tree whose leaves are `Dense` layers ({'kernel',
    optional 'bias'}), nested to any depth, → a state_dict whose keys join
    the path with '.' (`gcl_0.edge_mlp_0.weight`): the modules of
    `models/variants.py`, which name their submodules after the flax names,
    load it with `strict=True`."""
    tree = tree["params"] if "params" in tree else tree
    return {k: _tensor(v) for k, v in _dense_tree(tree, "").items()}


def _tensor(a) -> torch.Tensor:
    """A numpy leaf → a tensor: bf16 (ml_dtypes, which torch cannot read)
    through its fp32 value, exact, else float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(np.array(a, dtype=np.float32))


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

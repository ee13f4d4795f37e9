"""What the entries share: the engine configuration of a cell and the
weights, drawn from the seed on the device."""
from __future__ import annotations

import torch

# the configuration file's keys that are EngineConfig fields
ENGINE_KEYS = ("num_nodes", "k", "in_node_nf", "hidden_nf", "n_layers", "num_heads", "top_k",
               "lr", "lr_step", "lr_gamma", "lr_step_unit")


def engine_config(config: dict, path: str):
    """The program's EngineConfig of a configuration file on the cell's
    path: 'accurate' is `EngineConfig` itself (exact whole-cloud k-NN, fp32
    EGCL, SVD Kabsch), 'fast' is `fast_tpu_config` (Hilbert window of packed
    keys, bf16-operand EGCL, quaternion Kabsch), at the file's widths and
    loss weights."""
    from se3_equi_graph_registration_tpu_torch.train import engine, losses

    kw = {k: config[k] for k in ENGINE_KEYS}
    kw["loss_weights"] = losses.LossWeights(**config["loss_weights"])
    if path == "accurate":
        return engine.EngineConfig(**kw)
    if path == "fast":
        return engine.fast_tpu_config(egnn_window=config["egnn_window"],
                                      egnn_tile=config["egnn_tile"], **kw)
    raise ValueError(f"unknown engine path {path!r}")


def draw_weights(shapes: dict, seed: int, device) -> dict:
    """A state dict {name: float32 tensor on `device`} for the parameter
    shapes `shapes`, from one Gaussian and one uniform draw of a
    `torch.Generator` on the device seeded with `seed`: LeCun-normal
    matrices (fan-in from the last axis), per-head kernels at 1/√width, the
    coordinate output Xavier-uniform at gain 1e-3, unit LayerNorm scales,
    zero biases."""
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        shape = torch.Size(shape)
        n = shape.numel()
        g, u = normal[at:at + n].reshape(shape), uniform[at:at + n].reshape(shape)
        at += n
        if name.endswith("coord_mlp_out.weight"):
            fan_out, fan_in = shape
            out[name] = (u * 2.0 - 1.0) * (1e-3 * (6.0 / (fan_in + fan_out)) ** 0.5)
        elif name.endswith("head_kernels"):
            out[name] = g * shape[-2] ** -0.5
        elif len(shape) == 2:
            out[name] = g * shape[-1] ** -0.5
        elif name.endswith("layer_norm.weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def param_shapes(model) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}

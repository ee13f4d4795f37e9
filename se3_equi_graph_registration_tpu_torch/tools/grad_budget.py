"""Per-tensor gradient budget of the fast training path (counterpart of the
JAX package's `tools/grad_budget.py`).

It differentiates the loss that `train/engine.make_train_step`
differentiates (`losses.total_loss` over the engine's forward with graphs)
twice, on the same batch and the same weights: once at `fast_tpu_config`
(the bf16 tile kernels, packed k-NN keys) and once at its accurate twin (the
fp32 kernels, `egnn_accurate=True`, exact keys `knn_packed=False`), and
reports each tensor's gradient cosine and relative L2, worst first. The JAX
twin's `onehot_h_permute` is a TPU workaround the port does not have: the
port gathers exactly on both sides.

    python -m se3_equi_graph_registration_tpu_torch.tools.grad_budget --random-init
    python -m se3_equi_graph_registration_tpu_torch.tools.grad_budget \\
        --checkpoint checkpoint-3dmatch.pth --same-graph

Run it on the card: on the CPU both sides run the kernels' plain versions,
whose fast mode rounds the EGCL operands to bf16 but sums in another order
than the tile kernels, so the table there does not measure the kernels.

The two sides share the curve-window graph structure; packed-key near-ties
can still swap a few neighbors, so the table measures the fast config as
users run it (numerics and tie churn). `--same-graph` gives the fast side
exact keys too, which isolates the kernels' numerics.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Mapping, Optional, Union

import numpy as np
import torch


def flatten_named(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """A state_dict (or nested dicts of tensors) → {dotted name: float64
    array}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_named(v, name + "."))
        else:
            out[name] = v.detach().to("cpu", torch.float64).numpy() if torch.is_tensor(v) \
                else np.asarray(v, np.float64)
    return out


def gradients(params: Mapping[str, torch.Tensor], cfg, batch: dict) -> dict[str, np.ndarray]:
    """{parameter name: float64 gradient} of `total_loss` over the engine's
    training forward at `cfg`, with the weights `params`, on `batch` (an
    engine dict; the model is built on its device)."""
    from ..train import engine

    model = engine.build_model(cfg, head_mode="train", device=batch["src_pts"].device)
    model.load_state_dict(params)
    model.zero_grad(set_to_none=True)
    engine.train_loss(model, cfg, batch).total.backward()
    return flatten_named({n: p.grad for n, p in model.named_parameters()})


def accurate_twin(cfg):
    """The accurate twin of a fast config: the fp32 EGCL kernels
    (`egnn_accurate=True`) and exact k-NN keys (`knn_packed=False`), the rest
    as `cfg`."""
    return dataclasses.replace(cfg, egnn_accurate=True, knn_packed=False)


def grad_table(n: int = 2048, batch: int = 8, k: int = 16, c: int = 32, seed: int = 0,
               params: Optional[Mapping[str, torch.Tensor]] = None,
               fast_overrides: Optional[dict] = None,
               device: Union[str, torch.device, None] = None):
    """Returns (rows, fast_cfg, acc_cfg): rows = [(name, cosine, rel_l2)]
    sorted worst cosine first, over the batch `make_pair_batch` draws from
    `np.random.default_rng(seed)`. `params`: the model's state_dict (None:
    the seeded initialization `init_state` draws from generator seed 0).
    `fast_overrides`: EngineConfig fields for the fast side only, e.g.
    ``{"knn_packed": False}`` (the CLI's --same-graph)."""
    from ..data.synthetic import make_pair_batch
    from ..train import engine

    rng = np.random.default_rng(seed)
    pb = make_pair_batch(rng, batch=batch, n=n, feat_dim=c)
    batch_d = engine.batch_to_device(tuple(pb), device)
    base = engine.fast_tpu_config(num_nodes=n, k=k, in_node_nf=c, hidden_nf=32, top_k=128)
    fast_cfg = dataclasses.replace(base, **(fast_overrides or {}))
    acc_cfg = accurate_twin(base)
    if params is None:
        params = engine.init_state(fast_cfg, torch.Generator().manual_seed(0),
                                   device="cpu").model.state_dict()

    g_fast = gradients(params, fast_cfg, batch_d)
    g_acc = gradients(params, acc_cfg, batch_d)
    assert set(g_fast) == set(g_acc)
    return compare(g_fast, g_acc), fast_cfg, acc_cfg


def compare(a: Mapping[str, np.ndarray], b: Mapping[str, np.ndarray]) -> list:
    """[(name, cosine, relative L2 against the larger norm)] of two gradient
    dicts, sorted worst cosine first."""
    rows = []
    for name in sorted(a):
        x, y = a[name].ravel(), b[name].ravel()
        nx, ny = np.linalg.norm(x), np.linalg.norm(y)
        scale = max(nx, ny)
        if scale == 0:
            rows.append((name, 1.0, 0.0))
            continue
        cos = float(np.dot(x, y) / max(nx * ny, 1e-300))
        rows.append((name, cos, float(np.linalg.norm(x - y) / scale)))
    rows.sort(key=lambda r: r[1])
    return rows


def summary(rows: list) -> tuple[float, float, float]:
    """(worst cosine, worst relative L2, median relative L2) of a table."""
    rels = [r[2] for r in rows]
    return min(r[1] for r in rows), max(rels), float(np.median(rels))


def print_table(rows: list, what: str = "fast vs accurate") -> None:
    print(f"{'tensor':<48s} {'cosine':>10s} {'rel L2':>10s}")
    for name, cos, rel in rows:
        print(f"{name:<48s} {cos:10.7f} {rel:10.2e}")
    worst_cos, worst_rel, med_rel = summary(rows)
    print(f"\nworst cosine {worst_cos:.7f}  worst rel {worst_rel:.2e}  "
          f"median rel {med_rel:.2e}  ({len(rows)} tensors, {what})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--checkpoint", default=None,
                    help="reference .pth whose weights the table is taken at")
    ap.add_argument("--random-init", action="store_true",
                    help="the seeded initialization instead of a checkpoint")
    ap.add_argument("--same-graph", action="store_true",
                    help="fast side uses exact extraction keys (knn_packed=False): "
                         "isolates kernel numerics from packed-key tie churn")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; raises when "
                         "there is none)")
    args = ap.parse_args(argv)
    if (args.checkpoint is None) == (not args.random_init):
        ap.error("pass --checkpoint <file.pth> or --random-init")

    from ..device import resolve_device

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        print("WARNING: not on a CUDA card: both sides run the kernels' plain versions "
              "(fast mode rounds to bf16 but sums in another order than the tile "
              "kernels), so this run does not measure the kernels", file=sys.stderr)
    params = None
    if args.checkpoint:
        from ..train.checkpoints import convert_reference_checkpoint
        params = convert_reference_checkpoint(args.checkpoint)
    rows, _, _ = grad_table(n=args.n, batch=args.batch, params=params, device=dev,
                            fast_overrides={"knn_packed": False} if args.same_graph else None)
    print_table(rows)
    return rows


if __name__ == "__main__":
    main()

"""Coordinate-denoising training demo with the EGNN (the port's twin of the
JAX package's `examples/denoise.py`): corrupt synthetic point clouds with
Gaussian noise and train the EGNN's coordinate stream to undo it, with
gradient accumulation.

    python -m se3_equi_graph_registration_tpu_torch.examples.denoise [--steps 50]

The plain `models/egnn.EGNN` over the dense `ops/knn.knn_graph`, Adam at
optax's defaults, accumulated as `optax.MultiSteps` does: each step's loss
is taken at the current weights, the update is Adam on the mean of
`--accumulate-every` steps' gradients, and the weights and Adam's step
count move only on every k-th step. Runs on the CUDA card (`--device cpu`
for the CPU).
"""
from __future__ import annotations

import argparse
from typing import Callable, Mapping, Optional

import numpy as np


def denoise(steps: int = 50, n: int = 256, k: int = 16, noise: float = 0.1,
            accumulate_every: int = 4, device=None,
            state_dict: Optional[Mapping] = None,
            log: Callable[[str], None] = print) -> dict:
    """Train `steps` micro-steps; {'baseline': the first batch's noise MSE,
    'losses': every step's denoise MSE, 'final'}. `state_dict`: the EGNN's
    initial weights (default: the engine's seeded init)."""
    import torch

    from ..device import resolve_device
    from ..models.egnn import EGNN
    from ..ops import knn
    from ..train.checkpoints import init_weights

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    model = EGNN(in_node_nf=16, hidden_nf=32, out_node_nf=16, n_layers=3)
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    model = model.to(dev)

    def make_batch():
        clean = rng.standard_normal((n, 3)).astype(np.float32)
        noisy = clean + rng.standard_normal((n, 3)).astype(np.float32) * noise
        feats = rng.standard_normal((n, 16)).astype(np.float32)
        to = lambda a: torch.from_numpy(a)[None].to(dev)
        x = to(noisy)
        return to(feats), x, knn.knn_graph(x, k), to(clean)

    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    h, x, nbr, clean = make_batch()
    baseline = float(torch.mean((x - clean) ** 2))
    log(f"noise MSE before training: {baseline:.5f}")
    losses = []
    for i in range(steps):
        h, x, nbr, clean = make_batch()
        _, x_out = model(h, x, nbr)
        loss = torch.mean((x_out - clean) ** 2)
        (loss / accumulate_every).backward()        # the mean of k gradients
        if (i + 1) % accumulate_every == 0:
            opt.step()
            opt.zero_grad()
        losses.append(loss.item())
        if (i + 1) % 10 == 0:
            log(f"step {i + 1}: denoise MSE {losses[-1]:.5f}")
    final = losses[-1]
    log(f"final MSE {final:.5f} vs noise floor {baseline:.5f}")
    # the coord stream's init gain is 1e-3, so real denoising needs a few
    # hundred steps; short runs should at least not diverge
    if not final < baseline * 1.5:
        raise RuntimeError(f"training diverged: final MSE {final} against {baseline}")
    log("done")
    return {"baseline": baseline, "losses": losses, "final": final}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--noise", type=float, default=0.1)
    ap.add_argument("--accumulate-every", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    return denoise(args.steps, args.n, args.k, args.noise, args.accumulate_every, args.device)


if __name__ == "__main__":
    main()

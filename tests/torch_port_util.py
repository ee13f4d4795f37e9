"""Shared helpers of the port's parity tests (tests/test_torch_*.py): inputs
made with numpy from a seed, weights drawn by the JAX package and carried
into the port with `params_from_jax`."""
from __future__ import annotations

import jax
import numpy as np

NEAR_TIE_REL = 2.0 ** -12


def sorted_cloud(rng: np.random.Generator, b: int, n: int, c: int):
    """(h, x) [b, n, c] / [b, n, 3], x uniform in a 3 m cube, both permuted
    into Hilbert order by the JAX package's own sort."""
    import jax.numpy as jnp

    from se3_equi_graph_registration_tpu.ops import morton

    x = rng.uniform(-1.5, 1.5, (b, n, 3)).astype(np.float32)
    h = rng.standard_normal((b, n, c)).astype(np.float32)
    perm = np.asarray(morton.morton_perm(jnp.asarray(x)))
    return (np.take_along_axis(h, perm[..., None], 1),
            np.take_along_axis(x, perm[..., None], 1))


def jax_model_params(cfg, head_mode: str = "train", seed: int = 0):
    """Random flax params of the JAX RegistrationModel for `cfg` (numpy
    leaves), from `jax.jit(model.init)`."""
    from se3_equi_graph_registration_tpu.train import engine

    model = engine.build_model(cfg, head_mode=head_mode)
    n, c = cfg.num_nodes, cfg.in_node_nf
    f = np.zeros((1, n, c), np.float32)
    p = np.zeros((1, n, 3), np.float32)
    nbr = np.zeros((1, n, cfg.k), np.int32)
    lbl = np.ones((1, n), np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), f, p, nbr, f, p, nbr, lbl)
    return model, jax.tree_util.tree_map(np.asarray, params)


def neighbor_set_mismatches(x: np.ndarray, ref: np.ndarray, got: np.ndarray,
                            rel: float = NEAR_TIE_REL) -> int:
    """Rows whose neighbor sets differ, after checking that every swapped
    neighbor is a near-tie: its d² within `rel` (relative) of the row's
    k-th d² under the reference. Raises on any other difference."""
    mismatches = 0
    for b in range(ref.shape[0]):
        xb = x[b].astype(np.float64)
        for r in range(ref.shape[1]):
            se, sg = set(ref[b, r].tolist()), set(got[b, r].tolist())
            if se == sg:
                continue
            mismatches += 1
            d2 = ((xb[list(se ^ sg)] - xb[r]) ** 2).sum(-1)
            kth = ((xb[ref[b, r]] - xb[r]) ** 2).sum(-1).max()
            assert np.all(np.abs(d2 - kth) <= rel * max(kth, 1e-30)), (b, r, d2, kth)
    return mismatches

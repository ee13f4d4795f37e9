"""Port vs JAX: space-filling-curve codes, the curve sort and its inverse,
window starts, and the window-restricted k-NN graph."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu.ops import morton as jm
from se3_equi_graph_registration_tpu_torch.ops import morton as tm


def _cloud(rng, b=2, n=512, c=4):
    x = rng.uniform(-1.5, 1.5, (b, n, 3)).astype(np.float32)
    h = rng.standard_normal((b, n, c)).astype(np.float32)
    return h, x


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_curve_codes_bit_identical(rng, curve):
    _, x = _cloud(rng)
    ref = np.asarray(jm.curve_codes(jnp.asarray(x), curve=curve))
    got = tm.curve_codes(torch.from_numpy(x), curve=curve).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_sort_by_curve_same_permutation_and_unsort_inverts(rng):
    h, x = _cloud(rng)
    hs, xs, perm = jm.sort_by_curve(jnp.asarray(h), jnp.asarray(x))
    ths, txs, tperm = tm.sort_by_curve(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(xs))
    np.testing.assert_array_equal(ths.numpy(), np.asarray(hs))
    uh, ux = tm.unsort_rows((ths, txs), tperm)
    np.testing.assert_array_equal(uh.numpy(), h)
    np.testing.assert_array_equal(ux.numpy(), x)


def test_sort_is_stable_on_duplicate_codes():
    """Duplicate points share a code: the stable sort keeps index order."""
    x = np.repeat(np.random.default_rng(1).uniform(-1, 1, (64, 3)), 4, 0)
    _, _, perm = tm.sort_by_curve(torch.zeros(256, 1), torch.from_numpy(x).float())
    codes = tm.curve_codes(torch.from_numpy(x).float()).numpy()
    np.testing.assert_array_equal(perm.numpy(), np.argsort(codes, kind="stable"))


@pytest.mark.parametrize("n,tile,window", [(512, 128, 384), (2048, 128, 384),
                                           (512, 64, 512), (256, 128, 128)])
def test_window_starts_equal(n, tile, window):
    ref = np.asarray(jm.window_starts(n, tile, window))
    np.testing.assert_array_equal(tm.window_starts(n, tile, window).numpy(), ref)
    assert tm.window_start_at(3, tile, n, window) == int(jm.window_start_at(3, tile, n, window))


def test_knn_graph_window_same_sets(rng):
    """Exact-within-window graphs: equal neighbor sets row by row (random
    continuous coordinates, so no distance ties)."""
    _, x = _cloud(rng)
    _, xs, _ = tm.sort_by_curve(torch.zeros(2, 512, 1), torch.from_numpy(x))
    ref = np.asarray(jax.vmap(lambda p: jm.knn_graph_window(p, 16, tile=128, window=384))(
        jnp.asarray(xs.numpy())))
    got = tm.knn_graph_window(xs, 16, tile=128, window=384).numpy()
    assert got.dtype == np.int32 and got.shape == (2, 512, 16)
    for b in range(2):
        for r in range(512):
            assert set(got[b, r]) == set(ref[b, r]), (b, r)

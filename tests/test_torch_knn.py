"""Port vs JAX: the k-NN kernel's plain version against the Pallas kernel
run in interpret mode, in the three modes the kernel has.

Tolerance: neighbor SETS equal row by row, except near-ties — a swapped
neighbor whose d² lies within 2⁻¹² relative of the row's k-th d². The two
sides sum the cross term q·c in different orders (an XLA dot against the
port's fixed elementwise order), and packed keys drop 10 mantissa bits, so
candidates that close can trade places; the rows where that happens are
counted and must stay rare."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import neighbor_set_mismatches, sorted_cloud

from se3_equi_graph_registration_tpu.ops import knn as jknn
from se3_equi_graph_registration_tpu.ops.pallas.knn_kernel import knn_pallas
from se3_equi_graph_registration_tpu_torch.ops import knn as tknn
from se3_equi_graph_registration_tpu_torch.ops.kernels.knn import knn_window


@pytest.mark.parametrize("mode", [
    dict(window=384, packed=True),          # the served path
    dict(window=384),                       # window, exact keys
    dict(include_self=False),               # whole cloud, no self match
])
def test_plain_knn_matches_pallas_interpret(rng, mode):
    _, x = sorted_cloud(rng, 2, 512, 1)
    ref = np.asarray(knn_pallas(jnp.asarray(x), 16, tile_t=128, interpret=True, **mode))
    got = knn_window(torch.from_numpy(x.copy()), 16, tile=128, **mode).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    assert neighbor_set_mismatches(x, ref, got) <= 0.01 * 2 * 512
    if mode.get("include_self", True):
        assert all(r in got[b, r] for b in range(2) for r in range(512))
    else:
        assert not any(r in got[b, r] for b in range(2) for r in range(512))
    if "window" in mode:   # every neighbor inside its tile's window
        starts = np.repeat(np.asarray([0, 0, 128, 128]), 128)
        assert np.all(got >= starts[None, :, None])
        assert np.all(got < starts[None, :, None] + 384)


def test_dense_knn_graph_matches_jax(rng):
    x = rng.standard_normal((2, 256, 3)).astype(np.float32)
    ref = np.stack([np.asarray(jknn.knn_graph(jnp.asarray(p), 8)) for p in x])
    got = tknn.knn_graph(torch.from_numpy(x), 8).numpy()
    assert neighbor_set_mismatches(x, ref, got) <= 0.01 * 2 * 256
    no_self = tknn.knn_graph(torch.from_numpy(x), 8, include_self=False).numpy()
    assert not any(r in no_self[b, r] for b in range(2) for r in range(256))


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(1, 256, 3)
    with pytest.raises(ValueError):
        knn_window(x.double(), 8)
    with pytest.raises(ValueError):
        knn_window(x, 8, tile=128, window=None, packed=True)   # packed needs a window
    with pytest.raises(ValueError):
        knn_window(x, 8, tile=100, window=200)

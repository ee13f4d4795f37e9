"""Port vs JAX: the chunked window k-NN (B4) — its plain version against
`knn_pallas(chunked=True)` run in interpret mode — and B1 at the
checkpoint-free pipeline's k=60.

Tolerance: the lists equal row by row, in order, except at near-ties: a
swapped neighbor, or a swap of order, between candidates whose d² lie
within 2⁻¹² (relative to the row's k-th d²) of each other. The two sides
sum c·q in different orders and packed keys drop 10 mantissa bits, so such
candidates can trade places; rows with another set stay under 1%, rows
with another order under 2%."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import NEAR_TIE_REL, neighbor_set_mismatches

from se3_equi_graph_registration_tpu.ops import morton
from se3_equi_graph_registration_tpu.ops.pallas.knn_kernel import knn_pallas
from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as tknn


@pytest.fixture(scope="module")
def surface_cloud():
    """Two 512-point surface-like clouds (z squashed), Hilbert-sorted."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 512, 3)).astype(np.float32)
    x[..., 2] *= 0.2
    perm = np.asarray(morton.sort_by_curve(jnp.zeros((2, 512, 0)), jnp.asarray(x))[2])
    return np.take_along_axis(x, perm[..., None], 1)


def _same_up_to_near_ties(x, ref, got):
    assert got.dtype == np.int32 and got.shape == ref.shape
    rows = np.all(ref == got, axis=-1)
    assert neighbor_set_mismatches(x, ref, got) <= 0.01 * rows.size
    # where the sets agree, the order agrees up to the same near-ties:
    # position by position the two lists' d² stay within 2⁻¹² of the k-th
    same_set = np.all(np.sort(ref, -1) == np.sort(got, -1), axis=-1)
    for b, r in np.argwhere(same_set & ~rows):
        xb = x[b].astype(np.float64)
        dr = ((xb[ref[b, r]] - xb[r]) ** 2).sum(-1)
        dg = ((xb[got[b, r]] - xb[r]) ** 2).sum(-1)
        assert np.all(np.abs(dr - dg) <= NEAR_TIE_REL * dr.max()), (b, r)
    assert np.sum(same_set & ~rows) <= 0.02 * rows.size


@pytest.mark.parametrize("k,window", [(16, 256), (60, 256)])
def test_chunked_plain_matches_pallas_interpret(surface_cloud, k, window):
    x = surface_cloud
    ref = np.asarray(knn_pallas(jnp.asarray(x), k, tile_t=128, window=window, packed=True,
                                chunked=True, interpret=True))
    got = tknn.knn_chunked(torch.from_numpy(x.copy()), k, 128, window).numpy()
    _same_up_to_near_ties(x, ref, got)
    starts = np.repeat(np.asarray([0, 128, 256, 256]), 128)
    assert np.all(got >= starts[None, :, None]) and np.all(got < starts[None, :, None] + window)
    assert all(r in got[b, r] for b in range(2) for r in range(512))


def test_chunked_shortlist_is_its_own_function():
    """A window whose 60 nearest candidates all sit in residue class 0 mod 6:
    the shortlist keeps only S_pc = 20 of them, so B4 differs from packed
    mode (B1), and the plain version reproduces the Pallas kernel."""
    rng = np.random.default_rng(0)
    n = w = 768
    x = rng.uniform(0.5, 1.0, (1, n, 3)).astype(np.float32)
    x[0, ::6] = rng.uniform(-0.1, 0.1, (n // 6, 3))           # class 0: near the origin
    ref = np.asarray(knn_pallas(jnp.asarray(x), 60, tile_t=128, window=w, packed=True,
                                chunked=True, interpret=True))
    got = tknn.knn_chunked(torch.from_numpy(x), 60, 128, w).numpy()
    _same_up_to_near_ties(x, ref, got)
    packed = tknn.knn_window(torch.from_numpy(x), 60, 128, w, packed=True).numpy()
    q = 0                                                       # a class-0 query
    assert np.sum(packed[0, q] % 6 == 0) == 60
    assert np.sum(got[0, q] % 6 == 0) == 20


def test_chunked_plain_without_self(surface_cloud):
    x = surface_cloud
    ref = np.asarray(knn_pallas(jnp.asarray(x), 16, tile_t=128, window=256, packed=True,
                                chunked=True, include_self=False, interpret=True))
    got = tknn.knn_chunked(torch.from_numpy(x.copy()), 16, 128, 256, include_self=False).numpy()
    _same_up_to_near_ties(x, ref, got)
    assert not any(r in got[b, r] for b in range(2) for r in range(512))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
def test_window_knn_at_k60_matches_pallas_interpret(surface_cloud, packed):
    """B1 at the pipeline's k=60 (a new shape for it): window 256."""
    x = surface_cloud
    ref = np.asarray(knn_pallas(jnp.asarray(x), 60, tile_t=128, window=256, packed=packed,
                                interpret=True))
    got = tknn.knn_window(torch.from_numpy(x.copy()), 60, 128, 256, packed=packed).numpy()
    assert neighbor_set_mismatches(x, ref, got) <= 0.01 * 2 * 512


def test_chunked_wrapper_rejects_bad_geometry():
    x = torch.zeros(1, 512, 3)
    with pytest.raises(ValueError, match="128"):
        tknn.knn_chunked(x, 16, 64, 320)            # window not a multiple of 128
    with pytest.raises(ValueError, match="shortlist"):
        tknn.knn_chunked(x, 200, 128, 256)          # S_pc·C = 128 < k
    with pytest.raises(ValueError):
        tknn.knn_chunked(x.double(), 16, 128, 256)

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


@pytest.mark.parametrize("packed,window,want", [
    (True, 384, "warp"), (True, 1024, "warp"), (True, 128, "warp"),
    ("chunked", 768, "warp"), ("chunked", 128, "warp"),
    (False, 384, "warp"), (False, None, "warp"), (True, None, "thread"),
], ids=["packed-384", "packed-1024", "packed-128", "chunked-768", "chunked-128", "exact-384",
        "exact-whole-cloud", "packed-whole-cloud"])
def test_knn_variant_routes_packed_windows_and_chunked_keys_to_the_warp_kernels(
        packed, window, want):
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as kk

    assert kk.knn_variant(packed, window) == want


@pytest.mark.parametrize("window", [128, 384, 1024, 2048, None])
def test_knn_variant_routes_exact_keys_to_the_warp_kernel_up_to_k_128(window):
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as kk

    for k in (1, 16, 60, 128):
        assert kk.knn_variant(False, window, k) == "warp"
        assert kk.knn_window_source(False, window, k) == "knn_exact_warp"
    assert kk.knn_variant(False, window, 129) == "warp"
    assert kk.knn_window_source(False, window, 129) == "knn_exact_large"


@pytest.mark.parametrize("k", [129, 200, 300, 840, 1024])
def test_exact_keys_beyond_k_128_go_to_the_large_k_warp_kernel_up_to_its_limit(k):
    """128 < k ≤ 1024 runs `csrc/knn_exact_large.cu`, counted as 'warp';
    `variant='thread'` still names `csrc/knn.cu`, and packed keys
    `csrc/knn_warp.cu`."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as kk

    assert "knn_exact_large" in build.SOURCES
    for window in (768, 2048, None):
        assert kk.knn_variant(False, window, k) == "warp"
        assert kk.knn_window_source(False, window, k) == "knn_exact_large"
        assert kk.knn_window_source(False, window, k, "thread") == "knn"
    assert kk.knn_window_source(True, 1024, k) == "knn_warp"


def test_exact_keys_beyond_the_large_k_limit_raise_naming_it():
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as kk

    assert kk.EXACT_LARGE_MAX_K == 1024
    for window in (2048, None):
        with pytest.raises(ValueError, match=r"csrc/knn_exact_large.cu takes k <= 1024"):
            kk.knn_window_source(False, window, 1025)


@pytest.fixture
def recorded_launches(monkeypatch):
    """The CUDA side of `se3gspr_torch::knn_window` (`run_knn_window`) on CPU
    tensors, with `_launch` recording (source, symbol, integer arguments) in
    place of the launch, and the counters put back afterwards."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as kk

    calls = []
    monkeypatch.setattr(kk, "_launch", lambda source, symbol, x, out, *ints:
                        calls.append((source, symbol, ints)))
    monkeypatch.setattr(kk.knn_window, "launches", 0)
    monkeypatch.setattr(kk.knn_window, "launches_by_variant", {"warp": 0, "thread": 0})
    monkeypatch.setattr(kk.knn_window, "launches_by_source", dict.fromkeys(kk.WINDOW_SOURCES, 0))
    return calls


@pytest.mark.parametrize("window", [768, None], ids=["window-768", "whole-cloud"])
def test_large_k_exact_keys_launch_the_large_k_kernel_and_thread_only_when_asked(
        recorded_launches, window):
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as kk

    x = torch.zeros(2, 2048, 3)
    out = kk.run_knn_window(x, 300, 128, window, False, True, "warp", 0)
    assert out.shape == (2, 2048, 300) and out.dtype == torch.int32
    t, w, pad_tiles, max_tile = kk.exact_warp_geometry(2048, 300, 128, window)
    assert recorded_launches == [("knn_exact_large", "knn_exact_large_launch",
                                  (2, 2048, 300, t, w, pad_tiles, max_tile, 1, 1))]
    kk.run_knn_window(x, 300, 128, window, False, True, "thread", 64)
    assert recorded_launches[1][:2] == ("knn", "knn_launch")
    assert kk.knn_window.launches_by_variant == {"warp": 1, "thread": 1}
    assert kk.knn_window.launches_by_source == {"knn_warp": 0, "knn_exact_warp": 0,
                                                "knn_exact_large": 1, "knn": 1}
    with pytest.raises(ValueError, match="k <= 1024"):
        kk.run_knn_window(torch.zeros(1, 2048, 3), 1025, 128, None, False, True, "warp", 0)
    assert len(recorded_launches) == 2 and kk.knn_window.launches == 2


def test_exact_warp_geometry_treats_the_whole_cloud_as_one_tile():
    """The whole cloud is one window shared by every query: the exact warp
    kernel takes it as one tile of N queries (S = 0) whatever tile divides N;
    a window keeps the window-start formula's integers."""
    from se3_equi_graph_registration_tpu_torch.ops import morton
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as kk

    for n, tile in ((2048, 128), (2000, 125), (251, 1)):
        assert kk.exact_warp_geometry(n, 16, tile, None) == (n, n, 0, 0)
    t, w, pad_tiles, max_tile = kk.exact_warp_geometry(2048, 16, 128, 384)
    assert (t, w) == (128, 384)
    for i in range(2048 // 128):
        assert (min(max(i - pad_tiles, 0), max_tile) * t
                == morton.window_start_at(i, 128, 2048, 384))
    with pytest.raises(ValueError):
        kk.exact_warp_geometry(2000, 16, 128, None)      # the tile must divide N


def test_knn_counters_by_variant_exist_and_start_at_zero():
    """CPU tensors never launch a kernel, so the counters stay at 0 here."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as kk

    x = torch.zeros(1, 256, 3)
    kk.knn_window(x, 8, 128, 256, packed=True)
    kk.knn_chunked(x, 8, 128, 256)
    for fn in (kk.knn_window, kk.knn_chunked):
        assert fn.launches == 0 and fn.launches_by_variant == {"warp": 0, "thread": 0}


H100_SMEM_OPTIN = 232448    # 227 KB, an H100's opt-in shared memory a block


@pytest.mark.parametrize("k,packed,tile,want", [
    (16, False, 128, 128), (211, False, 128, 128), (212, False, 128, 64),
    (300, False, 128, 64), (422, False, 128, 64), (423, False, 128, 32), (844, False, 128, 32),
    (300, True, 128, 128), (60, False, 125, 125), (8, False, 1, 1), (300, False, 256, 64),
])
def test_thread_kernel_takes_fewer_queries_a_block_at_large_k(k, packed, tile, want):
    """csrc/knn.cu keeps each query's k keys (and in exact mode k distances)
    in shared memory beside 16 KB of staged candidates: a block takes the
    largest of 128, 64 and 32 queries of its tile whose lists fit."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as kk

    qb = kk.thread_queries_per_block(k, tile, packed, H100_SMEM_OPTIN)
    assert qb == want and tile % qb == 0
    assert kk.THREAD_STAGED_BYTES + k * qb * (4 if packed else 8) <= H100_SMEM_OPTIN


def test_thread_kernel_refuses_lists_beyond_32_queries_a_block_naming_the_limit():
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as kk

    with pytest.raises(ValueError, match=r"232448 bytes, so k <= 844"):
        kk.thread_queries_per_block(845, 128, False, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match=r"k <= 1688"):
        kk.thread_queries_per_block(1689, 128, True, H100_SMEM_OPTIN)


@pytest.mark.parametrize("include_self", [True, False], ids=["self", "no_self"])
def test_knn_tiled_has_the_sets_of_knn_graph_and_of_jax(rng, include_self):
    """The tiled k-NN gives knn_graph's table (ties at the lowest index)
    for a batch, and JAX knn_tiled's for each cloud, row by row and in
    order (JAX's is held one cloud at a time: its lax.map stacks tiles
    ahead of the batch axis and the final reshape does not move them back,
    so a batch comes out scrambled); an indivisible tile raises."""
    x = rng.uniform(-1.5, 1.5, (2, 256, 3)).astype(np.float32)
    got = tknn.knn_tiled(torch.from_numpy(x), 8, include_self=include_self, tile=64)
    whole = tknn.knn_graph(torch.from_numpy(x), 8, include_self=include_self)
    assert got.dtype == torch.int32 and got.shape == (2, 256, 8)
    np.testing.assert_array_equal(got.numpy(), whole.numpy())
    for b in range(2):
        ref = jknn.knn_tiled(jnp.asarray(x[b]), 8, include_self=include_self, tile=64)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="divisible"):
        tknn.knn_tiled(torch.from_numpy(x), 8, tile=100)


@pytest.mark.parametrize("direction", ["center", "cluster"])
def test_nbr_to_edge_list_matches_jax(rng, direction):
    """One graph [N, K] as JAX flattens it; a batch [B, N, K] (which the
    JAX function cannot take) graph by graph."""
    nbr = rng.integers(0, 32, (2, 32, 4)).astype(np.int32)
    batched = tknn.nbr_to_edge_list(torch.from_numpy(nbr), direction)
    for b in range(2):
        got = tknn.nbr_to_edge_list(torch.from_numpy(nbr[b]), direction)
        ref = jknn.nbr_to_edge_list(jnp.asarray(nbr[b]), direction)
        for g, r, whole in zip(got, ref, batched):
            assert g.dtype == torch.int32 and g.shape == (32 * 4,)
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            np.testing.assert_array_equal(whole[b].numpy(), g.numpy())
    with pytest.raises(ValueError, match="direction"):
        tknn.nbr_to_edge_list(torch.from_numpy(nbr), "sideways")

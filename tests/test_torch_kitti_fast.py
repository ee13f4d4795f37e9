"""Port vs JAX at KITTI's width in fast mode (C=33, one head), on the CPU.

- The port's plain fast EGCL layer and its plain fast backward (the card
  kernels' reference: `egcl_layer_plain(accurate=False)`,
  `egcl_backward_plain(accurate=False)`) against the JAX Pallas kernels in
  interpret mode with `accurate=False`, on one window graph (B=2, N=512,
  K=16, tile 128, window 384). The JAX interpreter runs fast mode in fp32
  on the CPU, so this is the bf16 budget of tests/test_torch_egcl.py:
  2e-2 of each tensor's max-abs scale (h′, the update x′ − x, agg_m, dh, dx
  and the 11 parameter gradients).
- The port's Registrar at `fast_tpu_config(**KITTI_SMALL)` (N=256, two
  layers, top_k = N, the curve window at 256 to fit N) against JAX's on the
  same params, `register_raw` held stage by stage as
  tests/test_torch_serving_raw.py holds it in accurate mode: the fitted
  clouds equal; the descriptors within 1e-3 on ≥ 98% of the entries; the
  matches equal on ≥ 95% of the rows; the port's register() on JAX's
  fitted, matched arrays against JAX's register_raw within the fast serving
  budget of tests/test_torch_serving.py (‖ΔR‖_F/√2 and |Δt| within 2e-2,
  the similarity mean within 2e-2 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving_raw import _jax_stages, _pair
from torch_port_util import jax_model_params, sorted_cloud

from se3_equi_graph_registration_tpu import serving as jserving
from se3_equi_graph_registration_tpu.models.egnn import EGNN as JaxEGNN
from se3_equi_graph_registration_tpu.ops import morton as jm
from se3_equi_graph_registration_tpu.ops.pallas.egcl_backward import egcl_backward_pallas
from se3_equi_graph_registration_tpu.ops.pallas.egcl_kernel import (
    egcl_layer_pallas, params_from_tree)
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu_torch import serving as tserving
from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl as tk
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as tb
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

B, N, C, K = 2, 512, 33, 16
BF16_BUDGET = 2e-2
KITTI_SMALL = dict(num_nodes=256, in_node_nf=33, hidden_nf=33, n_layers=2, num_heads=1,
                   top_k=256, egnn_window=256)
T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one torch thread, so that the lane's parallel workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def layer():
    """A C=33 one-head layer drawn by the JAX EGNN (coord output at
    O(1/√C), so the coordinate chain carries weight) and carried across
    with `params_from_jax`, on a Hilbert-sorted window graph."""
    rng = np.random.default_rng(33)
    h, x = sorted_cloud(rng, B, N, C)
    nbr = np.asarray(jax.vmap(lambda p: jm.knn_graph_window(p, K, tile=128, window=384))(
        jnp.asarray(x)))
    jmod = JaxEGNN(in_node_nf=C, hidden_nf=C, out_node_nf=C, n_layers=1, num_heads=1)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(3), h, x, nbr))
    co = params["params"]["gcl_0"]["coord_mlp_out"]
    co["kernel"] = rng.normal(0, C ** -0.5, co["kernel"].shape).astype(np.float32)
    egnn = EGNN(in_node_nf=C, hidden_nf=C, out_node_nf=C, n_layers=1, num_heads=1)
    sd = params_from_jax({"egnn": params["params"], "mlp": {}})
    egnn.load_state_dict({k[len("egnn."):]: v for k, v in sd.items()})
    return dict(h=h, x=x, nbr=nbr, jp=params_from_tree(params["params"]["gcl_0"]),
                p=tk.params_from_layer(egnn.gcl_0),
                dagg_m=rng.standard_normal((B, N, C)).astype(np.float32),
                dagg_x=rng.standard_normal((B, N, 3)).astype(np.float32))


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_BUDGET * scale, err_msg=what)


def _jax(a):
    """A [B, N, c] array in the Pallas kernels' [B, c, N] layout."""
    return jnp.asarray(a).swapaxes(1, 2)


def test_plain_fast_layer_at_c33_matches_pallas_interpret(layer):
    assert tk.egcl_variant(C, K, C, accurate=False) == "tile"      # the card runs CP=48
    jh, jx, jagg = egcl_layer_pallas(_jax(layer["h"]), _jax(layer["x"]),
                                     jnp.asarray(layer["nbr"]), layer["jp"], tile_t=128,
                                     chunk=512, interpret=True, accurate=False,
                                     emit_aggm=True, window=384)
    with torch.no_grad():
        th, tx, tagg = tk.egcl_layer(T(layer["h"]), T(layer["x"]), T(layer["nbr"]), layer["p"],
                                     accurate=False, return_aggm=True)
        ah, _ = tk.egcl_layer(T(layer["h"]), T(layer["x"]), T(layer["nbr"]), layer["p"],
                              accurate=True)
    x0 = layer["x"]
    _close(th, np.asarray(jh).swapaxes(1, 2), "h'")
    _close(np.asarray(tx) - x0, np.asarray(jx).swapaxes(1, 2) - x0, "x' - x")
    _close(tagg, np.asarray(jagg).swapaxes(1, 2), "agg_m")
    assert not torch.equal(th, ah)                                  # fast really rounds


@pytest.mark.parametrize("coord_only", [False, True], ids=["random", "coordinate-path"])
def test_plain_fast_backward_at_c33_matches_pallas_interpret(layer, coord_only):
    """dagg_m random, and 0 (every cotangent through agg_x and the
    coordinate MLP)."""
    dagg_m = np.zeros_like(layer["dagg_m"]) if coord_only else layer["dagg_m"]
    jdh, jdx, jdp = egcl_backward_pallas(_jax(layer["h"]), _jax(layer["x"]),
                                         jnp.asarray(layer["nbr"]), layer["jp"], _jax(dagg_m),
                                         _jax(layer["dagg_x"]), tile_t=128, chunk=512,
                                         interpret=True, window=384, accurate=False)
    with torch.no_grad():
        dh, dx, grads = tb.egcl_backward(T(layer["h"]), T(layer["x"]), T(layer["nbr"]),
                                         layer["p"], T(dagg_m), T(layer["dagg_x"]),
                                         accurate=False)
    _close(dh, np.asarray(jdh).swapaxes(1, 2), "dh")
    _close(dx, np.asarray(jdx).swapaxes(1, 2), "dx")
    assert set(grads) == set(tb.EDGE_PARAMS)
    for name in tb.EDGE_PARAMS:
        ref = np.asarray(getattr(jdp, name))
        _close(grads[name].numpy().reshape(ref.shape), ref, name)


@pytest.fixture(scope="module")
def registrars():
    _, params = jax_model_params(jengine.fast_tpu_config(**KITTI_SMALL), "eval_fusion")
    ref = jserving.Registrar(params, jengine.fast_tpu_config(**KITTI_SMALL))
    got = tserving.Registrar(params_from_jax(params), tengine.fast_tpu_config(**KITTI_SMALL),
                             device="cpu")
    return ref, got


def test_fast_registrar_at_kitti_width_matches_jax_register_raw(registrars):
    ref, got = registrars
    cfg = got.cfg
    assert not cfg.egnn_accurate and tk.egcl_variant(
        cfg.hidden_nf, cfg.k, cfg.hidden_nf // cfg.num_heads, False) == "tile"
    pairs = [_pair(1, 300), _pair(2, 300)]
    src, tgt = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    want = _jax_stages(pairs, 0.0, seed=4)
    c = {k: v.numpy() for k, v in got.raw_correspondences(src, tgt, seed=4).items()}
    for i, (sp, sf, tp, tf, j) in enumerate(want):
        np.testing.assert_array_equal(c["src_pts"][i], sp)
        np.testing.assert_array_equal(c["tgt_pts"][i], tp[c["matches"][i]])
        for f_got, f_want in ((c["src_feat"][i], sf), (c["tgt_feat"][i], tf[c["matches"][i]])):
            assert np.mean(np.abs(f_got - f_want) <= 1e-3) >= 0.98
        assert np.mean(c["matches"][i] == j) >= 0.95
    Rr, tr, ir = ref.register_raw(src, tgt, seed=4)
    stack = lambda q: np.stack([w[q] for w in want])
    Rg, tg, ig = got.register(stack(0), stack(1), np.stack([w[2][w[4]] for w in want]),
                              np.stack([w[3][w[4]] for w in want]), seed=4)
    assert np.all(np.linalg.norm(Rg - np.asarray(Rr), axis=(-2, -1)) / np.sqrt(2) < BF16_BUDGET)
    np.testing.assert_allclose(tg, np.asarray(tr), atol=BF16_BUDGET)
    assert abs(ig["similarity_mean"] - ir["similarity_mean"]) <= BF16_BUDGET * abs(
        ir["similarity_mean"])

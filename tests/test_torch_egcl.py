"""Port vs JAX: the fused EGCL layer's plain version against the Pallas
kernel in interpret mode, and the port's EGNN (module and kernel path)
against the Pallas and XLA EGNNs, on one window graph (N=512, k=16, C=16,
2 heads, 2 layers, tile 128, window 384).

Coordinates are compared through their update x' − x, relative to the
reference update's scale: the update is ~1e-2 against |x| ~1.5, so a check
on x' itself would pass a layer that left the coordinates unchanged.

Tolerances:
- accurate fp32: h to 1e-5 relative to its scale; the update to 1e-4
  relative to its scale (measured 1.3e-5 for one layer: the update is a sum
  of K products of MLP outputs, read back after the add to x). Both sides
  compute in fp32; only summation order differs.
- fast (bf16 MLP operands) against JAX accurate: 2e-2 relative, on h and
  on the update (measured 1.0e-2 and 7.4e-3). bf16 keeps 8 mantissa bits
  (~4e-3 relative per operand) and the error compounds over 2 layers; the
  JAX interpreter cannot run fast numerics on the CPU, so fast is held to
  accurate by this budget.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import sorted_cloud

from se3_equi_graph_registration_tpu.models.egnn import EGNN as JaxEGNN
from se3_equi_graph_registration_tpu.ops import morton as jm
from se3_equi_graph_registration_tpu.ops.pallas.egcl_kernel import (
    egcl_layer_pallas, egnn_forward_pallas, params_from_tree)
from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl as tk
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

B, N, C, K, HEADS, LAYERS = 2, 512, 16, 16, 2, 2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    h, x = sorted_cloud(rng, B, N, C)
    nbr = np.asarray(jax.vmap(lambda p: jm.knn_graph_window(p, K, tile=128, window=384))(
        jnp.asarray(x)))
    jmod = JaxEGNN(in_node_nf=C, hidden_nf=C, out_node_nf=C, n_layers=LAYERS,
                   num_heads=HEADS)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(0), h, x, nbr))
    sd = params_from_jax({"egnn": params["params"], "mlp": {}})
    egnn = EGNN(in_node_nf=C, hidden_nf=C, out_node_nf=C, n_layers=LAYERS,
                num_heads=HEADS)
    egnn.load_state_dict({k[len("egnn."):]: v for k, v in sd.items()})
    t = lambda a: torch.from_numpy(np.array(a))
    return dict(h=h, x=x, nbr=nbr, jmod=jmod, params=params, egnn=egnn,
                th=t(h), tx=t(x), tnbr=t(nbr))


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _close_update(got_x, ref_x, x0, rel):
    """x' against x' through the updates x' − x0, relative to the reference
    update's scale."""
    x0 = np.asarray(x0)
    ref_u = np.asarray(ref_x) - x0
    assert np.abs(ref_u).max() > 0
    _close(np.asarray(got_x) - x0, ref_u, rel)


def test_kernel_layout_params_match_params_from_tree(setup):
    ref = params_from_tree(setup["params"]["params"]["gcl_1"])
    got = tk.params_from_layer(setup["egnn"].gcl_1)
    assert got.head_width == C // HEADS
    for name, r in zip(ref._fields, ref):
        np.testing.assert_allclose(getattr(got, name).numpy().reshape(-1),
                                   np.asarray(r).reshape(-1), rtol=0, atol=1e-7,
                                   err_msg=name)


def test_plain_layer_matches_pallas_interpret_accurate(setup):
    jp = params_from_tree(setup["params"]["params"]["gcl_0"])
    jh, jx = egcl_layer_pallas(jnp.asarray(setup["h"]).swapaxes(1, 2),
                               jnp.asarray(setup["x"]).swapaxes(1, 2),
                               jnp.asarray(setup["nbr"]), jp, tile_t=128,
                               chunk=512, interpret=True, accurate=True, window=384)
    p = tk.params_from_layer(setup["egnn"].gcl_0)
    th, tx = tk.egcl_layer(setup["th"], setup["tx"], setup["tnbr"], p, accurate=True)
    _close(th, np.asarray(jh).swapaxes(1, 2), 1e-5)
    _close_update(tx, np.asarray(jx).swapaxes(1, 2), setup["x"], 1e-4)


def test_egnn_module_and_kernel_path_match_pallas_and_xla(setup):
    ph, px = egnn_forward_pallas(setup["params"], jnp.asarray(setup["h"]),
                                 jnp.asarray(setup["x"]), jnp.asarray(setup["nbr"]),
                                 tile_t=128, interpret=True, accurate=True, window=384)
    xh, xx = setup["jmod"].apply(setup["params"], setup["h"], setup["x"], setup["nbr"])
    with torch.no_grad():
        mh, mx = setup["egnn"](setup["th"], setup["tx"], setup["tnbr"])
        kh, kx = tk.egnn_forward(tk.kernel_params(setup["egnn"]), setup["th"],
                                 setup["tx"], setup["tnbr"], accurate=True)
    for h_, x_ in ((mh, mx), (kh, kx)):
        _close(h_, ph, 1e-5)
        _close_update(x_, px, setup["x"], 1e-4)
        _close(h_, xh, 1e-5)
        _close_update(x_, xx, setup["x"], 1e-4)


def test_fast_mode_within_bf16_budget_of_accurate(setup):
    ph, px = egnn_forward_pallas(setup["params"], jnp.asarray(setup["h"]),
                                 jnp.asarray(setup["x"]), jnp.asarray(setup["nbr"]),
                                 tile_t=128, interpret=True, accurate=True, window=384)
    kp = tk.kernel_params(setup["egnn"])
    with torch.no_grad():
        fh, fx = tk.egnn_forward(kp, setup["th"], setup["tx"], setup["tnbr"], accurate=False)
        ah, _ = tk.egnn_forward(kp, setup["th"], setup["tx"], setup["tnbr"], accurate=True)
    _close(fh, ph, 2e-2)
    _close_update(fx, px, setup["x"], 2e-2)
    assert not torch.equal(fh, ah)          # fast really rounds


def test_plain_layer_handles_c33_one_head(rng):
    """The KITTI preset's width (C=33, 1 head): plain kernel version against
    the readable module layer, fp32."""
    egnn = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=1)
    h = torch.from_numpy(rng.standard_normal((1, 256, 33)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 3)).astype(np.float32))
    from se3_equi_graph_registration_tpu_torch.ops.knn import knn_graph
    nbr = knn_graph(x, 8)
    ones = torch.ones(1, 256, 8, 1)
    with torch.no_grad():
        rh, rx = egnn.gcl_0(h, x, nbr, ones)
        gh, gx = tk.egcl_layer(h, x, nbr, tk.params_from_layer(egnn.gcl_0))
    _close(gh.numpy(), rh.numpy(), 1e-5)
    _close_update(gx.numpy(), rx.numpy(), x.numpy(), 1e-5)

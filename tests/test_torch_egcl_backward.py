"""Port vs JAX: the EGCL backward (the plain version of `csrc/egcl_backward.cu`)
against the Pallas backward kernel in interpret mode, the forward's agg_m
output, `EGCLFunction` against autograd, and the whole differentiable EGNN
against `jax.grad` through the Pallas EGNN, on one window graph (N=512,
k=16, C=16, 2 heads, tile 128, window 384, as tests/test_torch_egcl.py).

Tolerances (all fp32; only summation order differs between the sides):
- agg_m and the backward's dh, dx and 11 parameter gradients against the
  Pallas kernels: 1e-5 of each tensor's max-abs scale (measured ≤ 5.2e-7).
  The Pallas dw2 is compared on its diagonal head blocks: the port returns
  only those (the other entries of the block-diagonal w2 feed no parameter).
- the plain backward against autograd of the plain edge program: 1e-5.
- EGCLFunction and the differentiable EGNN against autograd / jax.grad:
  1e-4 of the scale (measured ≤ 3.1e-5: the coordinate chain through the
  node MLP and two layers adds summation noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import sorted_cloud

from se3_equi_graph_registration_tpu.models.egnn import EGNN as JaxEGNN
from se3_equi_graph_registration_tpu.ops import morton as jm
from se3_equi_graph_registration_tpu.ops.pallas.egcl_backward import egcl_backward_pallas
from se3_equi_graph_registration_tpu.ops.pallas.egcl_kernel import (
    egcl_layer_pallas, egnn_forward_pallas, params_from_tree)
from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl as tk
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as tb
from se3_equi_graph_registration_tpu_torch.ops.knn import knn_graph
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

B, N, C, K, HEADS, LAYERS = 2, 512, 16, 16, 2, 2
T = lambda a: torch.from_numpy(np.array(a))
NP = lambda t: t.detach().numpy()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    h, x = sorted_cloud(rng, B, N, C)
    nbr = np.asarray(jax.vmap(lambda p: jm.knn_graph_window(p, K, tile=128, window=384))(
        jnp.asarray(x)))
    jmod = JaxEGNN(in_node_nf=C, hidden_nf=C, out_node_nf=C, n_layers=LAYERS,
                   num_heads=HEADS)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(1), h, x, nbr))
    # a coord output far above flax's 1e-3-gain init, so the coordinate
    # chain carries weight in every gradient
    for li in range(LAYERS):
        co = params["params"][f"gcl_{li}"]["coord_mlp_out"]
        co["kernel"] = rng.normal(0, 0.3, co["kernel"].shape).astype(np.float32)
    sd = params_from_jax({"egnn": params["params"], "mlp": {}})
    egnn = EGNN(in_node_nf=C, hidden_nf=C, out_node_nf=C, n_layers=LAYERS, num_heads=HEADS)
    egnn.load_state_dict({k[len("egnn."):]: v for k, v in sd.items()})
    dagg_m = rng.standard_normal((B, N, C)).astype(np.float32)
    dagg_x = rng.standard_normal((B, N, 3)).astype(np.float32)
    return dict(h=h, x=x, nbr=nbr, params=params, egnn=egnn, dagg_m=dagg_m, dagg_x=dagg_x)


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale, err_msg=what)


def _jax_layout(name, t, c):
    """A port-layout gradient in the Pallas EGCLParams shape."""
    return t.reshape(c, 1) if name in ("b1", "b2", "ln_scale", "ln_bias", "bc0") else t


def test_plain_layer_agg_m_matches_pallas_emit_aggm(setup):
    jp = params_from_tree(setup["params"]["params"]["gcl_0"])
    jh, jx, jagg = egcl_layer_pallas(jnp.asarray(setup["h"]).swapaxes(1, 2),
                                     jnp.asarray(setup["x"]).swapaxes(1, 2),
                                     jnp.asarray(setup["nbr"]), jp, tile_t=128,
                                     chunk=512, interpret=True, accurate=True,
                                     emit_aggm=True, window=384)
    p = tk.params_from_layer(setup["egnn"].gcl_0)
    with torch.no_grad():
        th, tx, tagg = tk.egcl_layer(T(setup["h"]), T(setup["x"]), T(setup["nbr"]), p,
                                     accurate=True, return_aggm=True)
    _close(tagg, np.asarray(jagg).swapaxes(1, 2), 1e-5, "agg_m")
    _close(th, np.asarray(jh).swapaxes(1, 2), 1e-5, "h'")


def test_plain_backward_matches_pallas_interpret(setup):
    _backward_against_pallas(setup, setup["dagg_m"])


def test_plain_backward_matches_pallas_interpret_through_coordinates_only(setup):
    """dagg_m = 0: every cotangent reaches the edge MLP through agg_x and
    the coordinate MLP (dm = Wc0ᵀ·dcm_in), so each tensor's check is a
    check of that path."""
    _backward_against_pallas(setup, np.zeros_like(setup["dagg_m"]))


def _backward_against_pallas(s, dagg_m):
    jp = params_from_tree(s["params"]["params"]["gcl_1"])
    jdh, jdx, jdp = egcl_backward_pallas(
        jnp.asarray(s["h"]).swapaxes(1, 2), jnp.asarray(s["x"]).swapaxes(1, 2),
        jnp.asarray(s["nbr"]), jp, jnp.asarray(dagg_m).swapaxes(1, 2),
        jnp.asarray(s["dagg_x"]).swapaxes(1, 2), tile_t=128, chunk=512,
        interpret=True, window=384, accurate=True)
    p = tk.params_from_layer(s["egnn"].gcl_1)
    with torch.no_grad():
        dh, dx, grads = tb.egcl_backward(T(s["h"]), T(s["x"]), T(s["nbr"]), p,
                                         T(dagg_m), T(s["dagg_x"]), accurate=True)
    _close(dh, np.asarray(jdh).swapaxes(1, 2), 1e-5, "dh")
    _close(dx, np.asarray(jdx).swapaxes(1, 2), 1e-5, "dx")
    mask = tb.head_block_mask(C, C // HEADS).numpy()
    assert set(grads) == set(tb.EDGE_PARAMS)
    for name in tb.EDGE_PARAMS:
        ref = np.asarray(getattr(jdp, name))
        if name == "w2":
            ref = ref * mask
            assert np.all(NP(grads[name])[~mask] == 0)
        _close(_jax_layout(name, NP(grads[name]), C), ref, 1e-5, name)


def test_plain_backward_matches_autograd_of_the_edge_program(setup):
    s = setup
    p = tk.params_from_layer(s["egnn"].gcl_0)
    h, x = T(s["h"]).requires_grad_(), T(s["x"]).requires_grad_()
    with torch.no_grad():
        leaves = [t.clone().requires_grad_() for t in p[:11]]
    lp = tk.EGCLParams(*leaves, *p[11:])
    agg_m, agg_x = tk.edge_aggregates_plain(h, x, T(s["nbr"]), lp, accurate=True)
    loss = (agg_m * T(s["dagg_m"])).sum() + (agg_x * T(s["dagg_x"])).sum()
    ref = torch.autograd.grad(loss, [h, x, *leaves])
    with torch.no_grad():
        dh, dx, grads = tb.egcl_backward_plain(T(s["h"]), T(s["x"]), T(s["nbr"]), p,
                                               T(s["dagg_m"]), T(s["dagg_x"]), accurate=True)
    _close(NP(dh), NP(ref[0]), 1e-5, "dh")
    _close(NP(dx), NP(ref[1]), 1e-5, "dx")
    mask = tb.head_block_mask(C, C // HEADS)
    for name, r in zip(tb.EDGE_PARAMS, ref[2:]):
        r = r * mask if name == "w2" else r
        _close(NP(grads[name]), NP(r), 1e-5, name)


def test_egcl_function_matches_autograd_of_the_plain_layer(setup):
    """Gradients to h, x and every parameter of the module, through the
    folds: b1 = bias + the edge_attr column, w2 = block_diag(head_kernels)ᵀ."""
    s = setup
    layer = s["egnn"].gcl_1
    gen = torch.Generator().manual_seed(2)
    ch, cx = torch.randn(B, N, C, generator=gen), torch.randn(B, N, 3, generator=gen)

    def grads(fn):
        layer.zero_grad(set_to_none=True)
        h, x = T(s["h"]).requires_grad_(), T(s["x"]).requires_grad_()
        p = tk.live_params(layer)
        ho, xo = fn(h, x, T(s["nbr"]), p)
        ((ho * ch).sum() + (xo * cx).sum()).backward()
        return dict(h=NP(h.grad), x=NP(x.grad),
                    **{n: NP(q.grad) for n, q in layer.named_parameters()})

    got = grads(lambda h, x, nbr, p: tb.EGCLFunction.apply(h, x, nbr, p.head_width, True, None,
                                                             *p[:-1]))
    ref = grads(lambda h, x, nbr, p: tk.egcl_layer_plain(h, x, nbr, p, True))
    assert set(got) == set(ref) and len(ref) == 2 + 13
    for name in ref:
        _close(got[name], ref[name], 1e-4, name)
    # db1 reaches both the bias and the edge_attr (=1) column of fused_in;
    # dw2's diagonal blocks reach head_kernels
    w1 = got["edge_mlp.fused_in.weight"]
    np.testing.assert_allclose(w1[:, 2 * C + 12], got["edge_mlp.fused_in.bias"], atol=1e-7)
    assert np.abs(got["edge_mlp.head_kernels"]).max() > 0


def test_differentiable_egnn_matches_jax_grad_through_pallas(setup):
    s = setup
    gen = np.random.default_rng(7)
    ch = gen.standard_normal((B, N, C)).astype(np.float32)
    cx = gen.standard_normal((B, N, 3)).astype(np.float32)

    def jloss(params, h, x):
        ho, xo = egnn_forward_pallas(params, h, x, jnp.asarray(s["nbr"]), tile_t=128,
                                     interpret=True, accurate=True, window=384)
        return jnp.sum(ho * ch) + jnp.sum(xo * cx)

    jg, jgh, jgx = jax.grad(jloss, argnums=(0, 1, 2))(
        s["params"], jnp.asarray(s["h"]), jnp.asarray(s["x"]))
    ref = params_from_jax({"egnn": jax.tree_util.tree_map(np.asarray, jg["params"]),
                           "mlp": {}})
    egnn = s["egnn"]
    egnn.zero_grad(set_to_none=True)
    h, x = T(s["h"]).requires_grad_(), T(s["x"]).requires_grad_()
    ho, xo = tk.egnn_forward(tk.kernel_params(egnn), h, x, T(s["nbr"]),
                             accurate=True)
    ((ho * T(ch)).sum() + (xo * T(cx)).sum()).backward()
    _close(NP(h.grad), np.asarray(jgh), 1e-4, "h")
    _close(NP(x.grad), np.asarray(jgx), 1e-4, "x")
    for name, q in egnn.named_parameters():
        _close(NP(q.grad), ref["egnn." + name].numpy(), 1e-4, name)


def test_degenerate_edges_give_finite_gradients():
    """All points identical: every edge is a self-loop-like zero vector
    (dist, the frame and the cross product all degenerate)."""
    egnn = EGNN(in_node_nf=8, hidden_nf=8, out_node_nf=8, n_layers=2, num_heads=2)
    h = torch.randn(1, 64, 8, requires_grad=True)
    x = torch.full((1, 64, 3), 0.25, requires_grad=True)
    nbr = knn_graph(x.detach(), 8)
    ho, xo = tk.egnn_forward(tk.kernel_params(egnn), h, x, nbr)
    (ho.sum() + xo.sum()).backward()
    for t in (h.grad, x.grad, *(q.grad for q in egnn.parameters())):
        assert t is not None and torch.all(torch.isfinite(t))


def test_c33_one_head_backward_matches_autograd():
    """The KITTI preset's width (C=33, 1 head)."""
    egnn = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=1)
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(1, 256, 33, generator=gen)
    x = torch.rand(1, 256, 3, generator=gen) * 3 - 1.5
    nbr = knn_graph(x, 8)
    dm, dx_ = torch.randn(1, 256, 33, generator=gen), torch.randn(1, 256, 3, generator=gen)
    p = tk.params_from_layer(egnn.gcl_0)
    with torch.no_grad():
        leaves = [t.clone().requires_grad_() for t in p[:11]]
    hh, xx = h.clone().requires_grad_(), x.clone().requires_grad_()
    am, ax = tk.edge_aggregates_plain(hh, xx, nbr, tk.EGCLParams(*leaves, *p[11:]))
    ref = torch.autograd.grad((am * dm).sum() + (ax * dx_).sum(), [hh, xx, *leaves])
    with torch.no_grad():
        dh, dx, grads = tb.egcl_backward(h, x, nbr, p, dm, dx_)
    _close(NP(dh), NP(ref[0]), 1e-5, "dh")
    _close(NP(dx), NP(ref[1]), 1e-5, "dx")
    for name, r in zip(tb.EDGE_PARAMS, ref[2:]):
        _close(NP(grads[name]), NP(r), 1e-5, name)

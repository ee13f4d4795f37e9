"""Port vs JAX: the model zoo (`models/variants.py`) on the same numpy inputs
and the same weights, carried across by
`train/checkpoints.dense_params_from_jax` and loaded with strict=True.

The JAX side is jitted (init and apply), but for ClofGCL, which runs op
by op: XLA's fusions under jit may contract products into FMAs and move
the last bits, which the 1e-5 gates absorb, but ClofGCL's degeneracy cut is
a comparison that such bits can flip, so its frames and outputs are held
to the op-by-op function.

Tolerances: each output within 1e-5 of its max-abs scale (B=2, N=64, K=8,
C=16, float32); the JAX tests' own properties on the port: rotation
equivariance within 2e-4, a tensor-product layer that ignores a rotation of
orthonormal frames within 1e-4, a symmetric adjacency within 1e-5, shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu.data.synthetic import random_rotation
from se3_equi_graph_registration_tpu.models import variants as jv
from se3_equi_graph_registration_tpu.ops import knn as jknn
from se3_equi_graph_registration_tpu_torch.models import variants as tv
from se3_equi_graph_registration_tpu_torch.train.checkpoints import dense_params_from_jax

B, N, K, C = 2, 64, 8, 16
T = torch.from_numpy
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one torch thread, so that the lane's parallel workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((B, N, C)).astype(np.float32)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    v = (rng.standard_normal((B, N, 3)) * 0.1).astype(np.float32)
    nbr = np.array(jax.vmap(lambda p: jknn.knn_graph(p, K))(jnp.asarray(x)))
    return h, x, v, nbr


def _port(module, params):
    sd = dense_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    module.load_state_dict(sd, strict=True)
    return module


def _close(got, ref, what):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    gap = np.abs(got - ref).max() / scale
    assert gap <= 1e-5, f"{what}: max|Δ| {gap:.3g} of the scale {scale:.3g}"


def _rot(seed):
    return random_rotation(np.random.default_rng(seed)).astype(np.float32)


def test_converter_names_the_flax_tree():
    """Every Dense of a nested flax tree becomes `<path>.weight` [out, in]
    and `<path>.bias`; a kernel without bias gives only the weight."""
    tree = {"params": {"a": {"kernel": np.ones((3, 2)), "bias": np.zeros(2)},
                       "b": {"c": {"kernel": np.arange(6.0).reshape(2, 3)}}}}
    sd = dense_params_from_jax(tree)
    assert sorted(sd) == ["a.bias", "a.weight", "b.c.weight"]
    assert sd["b.c.weight"].shape == (3, 2) and sd["b.c.weight"].dtype == torch.float32
    np.testing.assert_array_equal(sd["b.c.weight"].numpy(), np.arange(6.0).reshape(2, 3).T)


def test_so3_tensor_product_layer(inputs):
    frames = np.stack([_rot(i).reshape(9) for i in range(10)])
    jl = jv.SO3TensorProductLayer(3, 8)
    params = jax.jit(jl.init)(KEY, jnp.asarray(frames))
    tl = _port(tv.SO3TensorProductLayer(3, 8), params)
    _close(tl(T(frames)), jax.jit(jl.apply)(params, jnp.asarray(frames)), "so3_tp")
    R = _rot(1)
    rotated = np.einsum("ij,njk->nik", R, frames.reshape(10, 3, 3)).reshape(10, 9)
    np.testing.assert_allclose(tl(T(rotated)).detach().numpy(), tl(T(frames)).detach().numpy(),
                               atol=1e-4)


def test_clean_egnn(inputs):
    h, x, _, nbr = inputs
    jm = jv.CleanEGNN(in_node_nf=C, hidden_nf=32, out_node_nf=24, n_layers=2)
    params = jax.jit(jm.init)(KEY, h, x, nbr)
    tm = _port(tv.CleanEGNN(C, 32, 24, 2), params)
    assert "gcl_1.so3_tp.dense_0.weight" in tm.state_dict()
    mask = (np.random.default_rng(1).uniform(size=(B, N, K)) < 0.8).astype(np.float32)
    for m in (None, mask):
        ref = jax.jit(jm.apply)(params, h, x, nbr, None if m is None else jnp.asarray(m))
        got = tm(T(h), T(x), T(nbr), None if m is None else T(m))
        _close(got[0], ref[0], "clean h")
        _close(got[1] - T(x), np.asarray(ref[1]) - x, "clean x update")
    hs, xs = tm(T(h), T(x), T(nbr))
    (hs.square().sum() + xs.square().sum()).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tm.parameters())


def test_gcl_and_radial_field(inputs):
    h, x, _, nbr = inputs
    jg = jv.GCL(hidden_nf=32)
    pg = jax.jit(jg.init)(KEY, h, nbr)
    tg = _port(tv.GCL(C, 32), pg)
    _close(tg(T(h), T(nbr)), jax.jit(jg.apply)(pg, h, nbr), "gcl")

    jr = jv.GCLrf(hidden_nf=16)
    pr = jax.jit(jr.init)(KEY, x, nbr)
    tr = _port(tv.GCLrf(16), pr)
    x2 = tr(T(x), T(nbr))
    _close(x2 - T(x), np.asarray(jax.jit(jr.apply)(pr, x, nbr)) - x, "radial field update")
    R = _rot(2)
    np.testing.assert_allclose(tr(T(x @ R.T), T(nbr)).detach().numpy(),
                               x2.detach().numpy() @ R.T, atol=2e-4)


def _degenerate_ratio(x, nbr):
    """‖x_i × x_j‖ / (‖x_i‖‖x_j‖) per edge, in float64."""
    x = x.astype(np.float64)
    xj = np.take_along_axis(x[:, :, None, :], nbr[..., None].astype(np.int64), axis=1)
    xi = np.broadcast_to(x[:, :, None, :], xj.shape)
    return np.linalg.norm(np.cross(xi, xj), axis=-1) / (
        np.linalg.norm(xi, axis=-1) * np.linalg.norm(xj, axis=-1))


def test_clof_gcl_degeneracy_cut_and_outputs(inputs):
    """The degenerate masks agree first (the self-loops, ratio 0, and any
    pair below the cut); no pair lies within 1e-5 of the 1e-3 cut, where
    fp32 rounding could flip it (counted: 0 of B·N·K); then the outputs."""
    h, x, _, nbr = inputs
    ratio = _degenerate_ratio(x, nbr)
    near = int(np.sum(np.abs(ratio - 1e-3) < 1e-5))
    assert near == 0, f"{near} edges within rounding of the cut"
    got_frame = tv.coord2localframe(T(x), T(nbr)).numpy()
    ref_frame = np.asarray(jv.coord2localframe(jnp.asarray(x), jnp.asarray(nbr)))
    degen_got = np.all(got_frame[..., 0, :] == 0, axis=-1)
    degen_ref = np.all(ref_frame[..., 0, :] == 0, axis=-1)
    np.testing.assert_array_equal(degen_got, degen_ref)
    assert degen_got.sum() >= B * N and np.array_equal(degen_got, ratio < 1e-3)
    np.testing.assert_allclose(got_frame, ref_frame, atol=1e-5)

    jl = jv.ClofGCL(hidden_nf=32)
    params = jax.jit(jl.init)(KEY, h, x, nbr)
    tl = _port(tv.ClofGCL(C, 32), params)
    ref = jl.apply(params, h, x, nbr)
    got = tl(T(h), T(x), T(nbr))
    _close(got[0], ref[0], "clof h")
    _close(got[1] - T(x), np.asarray(ref[1]) - x, "clof x update")
    R = _rot(3)
    h2, x2 = tl(T(h), T(x @ R.T), T(nbr))
    np.testing.assert_allclose(h2.detach().numpy(), got[0].detach().numpy(), atol=2e-4)
    np.testing.assert_allclose(x2.detach().numpy(), got[1].detach().numpy() @ R.T, atol=2e-4)


def test_egcl_vel(inputs):
    h, x, v, nbr = inputs
    jl = jv.EGCLVel(hidden_nf=32)
    params = jax.jit(jl.init)(KEY, h, x, v, nbr)
    tl = _port(tv.EGCLVel(C, 32), params)
    ref = jax.jit(jl.apply)(params, h, x, v, nbr)
    got = tl(T(h), T(x), T(v), T(nbr))
    _close(got[0], ref[0], "vel h")
    _close(got[1] - T(x), np.asarray(ref[1]) - x, "vel x update")
    _close(got[2], ref[2], "vel v")
    R = _rot(4)
    h2, x2, v2 = tl(T(h), T(x @ R.T), T(v @ R.T), T(nbr))
    np.testing.assert_allclose(h2.detach().numpy(), got[0].detach().numpy(), atol=2e-4)
    np.testing.assert_allclose(x2.detach().numpy(), got[1].detach().numpy() @ R.T, atol=2e-4)
    np.testing.assert_allclose(v2.detach().numpy(), got[2].detach().numpy() @ R.T, atol=2e-4)


@pytest.mark.parametrize("threshold", [0.0, 0.3])
def test_legacy_gcn_path(inputs, threshold):
    h, x, _, _ = inputs
    adj_ref = jv.build_gaussian_adjacency(jnp.asarray(x), sigma=0.8, threshold=threshold)
    adj = tv.build_gaussian_adjacency(T(x), sigma=0.8, threshold=threshold)
    assert adj.shape == (B, N, N)
    _close(adj, adj_ref, "adjacency")
    np.testing.assert_allclose(adj.numpy(), adj.transpose(1, 2).numpy(), atol=1e-5)
    jl = jv.GraphConvolution(out_features=20)
    params = jax.jit(jl.init)(KEY, h, adj_ref)
    tl = _port(tv.GraphConvolution(C, 20), params)
    out_ref = jax.jit(jl.apply)(params, h, adj_ref)
    out = tl(T(h), adj)
    _close(out, out_ref, "gcn")
    pooled = tv.GlobalPooling()(out)
    assert pooled.shape == (B, 40)
    _close(pooled, jv.GlobalPooling().apply({}, out_ref), "pooling")


def _tf32(t):
    """t rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("rounding", ["bf16", "tf32"])
def test_the_card_gate_on_the_gcn_fails_a_low_precision_einsum(rounding):
    """chip_smoke.py holds the legacy GCN, card against CPU, at
    EXTRAS_GCN_TOL of the scale. At its width (N=2048; B=1 here) the fp32
    CPU sits far inside that gate from a float64 evaluation, and an einsum
    whose operands were rounded to bf16 or to TF32, as TF32 matmuls on the
    card would round them, fails it."""
    import chip_smoke

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1.5, 1.5, (1, 2048, 3)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((1, 2048, 32)).astype(np.float32))
    layer = chip_smoke.seeded(tv.GraphConvolution(32, 32), 7)

    class Rounded(tv.GraphConvolution):
        def forward(self, h, adj):
            r = _tf32 if rounding == "tf32" else lambda t: t.to(torch.bfloat16).float()
            return self.act(torch.einsum("...nm,...mc->...nc", r(adj), r(self.weight(h))))

    planted = Rounded(32, 32)
    planted.load_state_dict(layer.state_dict())
    with torch.no_grad():
        fp32 = chip_smoke.gcn_forward(torch, layer, h, x)
        low = chip_smoke.gcn_forward(torch, planted, h, x)
        fp64 = chip_smoke.gcn_forward(torch, layer.double(), h.double(), x.double())
    gap = lambda a, b: chip_smoke.rel_gap(torch, a, b)
    assert gap(fp32[1], fp64[1]) < 0.1 * chip_smoke.EXTRAS_GCN_TOL
    assert gap(fp32[2], fp64[2]) < 0.1 * chip_smoke.EXTRAS_GCN_TOL
    assert gap(low[1], fp32[1]) > 10 * chip_smoke.EXTRAS_GCN_TOL, gap(low[1], fp32[1])

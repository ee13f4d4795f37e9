"""Port vs JAX: `utils/nn_extras` and `utils/reversible`, on the same numpy
inputs and weights.

Tolerances: nn_extras 1e-6 (the same elementwise float32 math); reversible
blocks: the inverse round trip 1e-5, parameter and input gradients 1e-5
against the plain composition in torch and against JAX's custom-VJP blocks
(both sides float32, tanh MLPs of width 8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from se3_equi_graph_registration_tpu.utils import nn_extras as jx
from se3_equi_graph_registration_tpu.utils import reversible as jrev
from se3_equi_graph_registration_tpu_torch.utils import nn_extras as tx
from se3_equi_graph_registration_tpu_torch.utils import reversible as trev

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one torch thread, so that the lane's parallel workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_to_order_and_cache():
    assert [tx.to_order(d) for d in range(4)] == [jx.to_order(d) for d in range(4)]
    calls = []

    @tx.cache
    def square(a):
        calls.append(a)
        return a * a

    assert square(3) == 9 and square(3) == 9 and calls == [3]


@pytest.mark.parametrize("include_self", [True, False])
def test_fourier_encode_matches_jax(rng, include_self):
    x = rng.standard_normal((4, 5, 3)).astype(np.float32)
    ref = np.asarray(jx.fourier_encode(jnp.asarray(x), 3, include_self))
    got = tx.fourier_encode(T(x), 3, include_self).numpy()
    assert got.shape == ref.shape == (4, 5, 3 * (6 + include_self))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_masked_mean_and_batched_index_select_match_jax(rng):
    t = rng.standard_normal((3, 7, 5)).astype(np.float32)
    m = rng.uniform(size=(3, 7, 5)) < 0.5
    m[0, 0] = False                                     # an empty row → 0
    for axis in (-1, 1):
        ref = np.asarray(jx.masked_mean(jnp.asarray(t), jnp.asarray(m), axis=axis))
        np.testing.assert_allclose(tx.masked_mean(T(t), T(m), dim=axis).numpy(), ref, atol=1e-6)
    assert tx.masked_mean(T(t), T(m))[0, 0] == 0.0
    idx = rng.integers(0, 7, (3, 4))
    ref = np.asarray(jx.batched_index_select(jnp.asarray(t), jnp.asarray(idx), axis=1))
    got = tx.batched_index_select(T(t), T(idx), dim=1).numpy()
    assert got.shape == (3, 4, 5)
    np.testing.assert_array_equal(got, ref)


def test_rotary_embeddings_match_jax(rng):
    x = rng.standard_normal((6, 8)).astype(np.float32)
    pos = np.arange(6, dtype=np.float32) * 3.0
    sc_ref = np.asarray(jx.sinusoidal_embeddings(jnp.asarray(pos), 8))
    sc = tx.sinusoidal_embeddings(T(pos), 8)
    np.testing.assert_allclose(sc.numpy(), sc_ref, atol=1e-6)
    np.testing.assert_allclose(tx.rotate_half(T(x)).numpy(),
                               np.asarray(jx.rotate_half(jnp.asarray(x))), atol=0)
    y = tx.apply_rotary_pos_emb(T(x), sc)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jx.apply_rotary_pos_emb(jnp.asarray(x), jnp.asarray(sc_ref))),
        atol=1e-6)
    np.testing.assert_allclose(y.norm(dim=-1).numpy(), np.linalg.norm(x, axis=-1), rtol=1e-5)


# --- reversible blocks ---

D, BLOCKS = 8, 3


class TanhMLP(nn.Module):
    """tanh(x @ w) + b, the JAX test's block function."""

    def __init__(self, w, b):
        super().__init__()
        self.w, self.b = nn.Parameter(T(w)), nn.Parameter(T(b))

    def forward(self, x):
        return torch.tanh(x @ self.w) + self.b


def _weights(rng):
    return [tuple((rng.standard_normal((D, D)).astype(np.float32) * 0.3,
                   rng.standard_normal(D).astype(np.float32) * 0.1) for _ in range(2))
            for _ in range(BLOCKS)]


def _modules(weights):
    fs = nn.ModuleList(TanhMLP(*wf) for wf, _ in weights)
    gs = nn.ModuleList(TanhMLP(*wg) for _, wg in weights)
    return fs, gs


def _plain(fs, gs, a1, a2):
    for f, g in zip(fs, gs):
        a1 = a1 + f(a2)
        a2 = a2 + g(a1)
    return a1, a2


def _grads(fs, gs, x1, x2, run):
    x1, x2 = T(x1).requires_grad_(True), T(x2).requires_grad_(True)
    a, b = run(fs, gs, x1, x2)
    (torch.sum(a ** 2) + torch.sum(b ** 2)).backward()
    out = {"x1": x1.grad.clone(), "x2": x2.grad.clone()}
    for name, p in list(fs.named_parameters(prefix="f")) + list(gs.named_parameters(prefix="g")):
        assert p.grad is not None, f"{name}: no gradient reached the parameter"
        out[name] = p.grad.clone()
        p.grad = None
    return out


def test_reversible_round_trip_and_gradients_match_plain_and_jax(rng):
    weights = _weights(rng)
    x1 = rng.standard_normal((4, D)).astype(np.float32)
    x2 = rng.standard_normal((4, D)).astype(np.float32)
    fs, gs = _modules(weights)
    y1, y2 = trev.reversible_sequence(fs, gs, T(x1), T(x2))
    p1, p2 = _plain(fs, gs, T(x1), T(x2))
    np.testing.assert_allclose(y1.detach().numpy(), p1.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(y2.detach().numpy(), p2.detach().numpy(), atol=1e-6)
    r1, r2 = trev.invert_sequence(fs, gs, y1, y2)
    np.testing.assert_allclose(r1.numpy(), x1, atol=1e-5)
    np.testing.assert_allclose(r2.numpy(), x2, atol=1e-5)

    rev = _grads(fs, gs, x1, x2, trev.reversible_sequence)
    plain = _grads(fs, gs, x1, x2, _plain)
    assert set(rev) == set(plain)
    for k in rev:
        np.testing.assert_allclose(rev[k].numpy(), plain[k].numpy(), atol=1e-5, err_msg=k)

    # JAX: the same blocks as its custom-VJP sequence, gradients by jax.grad
    mlp = lambda p, x: jnp.tanh(x @ p["w"]) + p["b"]
    ps = [tuple({"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in blk) for blk in weights]

    def loss(ps_, a1, a2):
        a, b = jrev.reversible_sequence([mlp] * BLOCKS, [mlp] * BLOCKS, a1, a2, ps_)
        return jnp.sum(a ** 2) + jnp.sum(b ** 2)

    gp, g1, g2 = jax.grad(loss, argnums=(0, 1, 2))(ps, jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(rev["x1"].numpy(), np.asarray(g1), atol=1e-5)
    np.testing.assert_allclose(rev["x2"].numpy(), np.asarray(g2), atol=1e-5)
    for i, (gf, gg) in enumerate(gp):
        for side, g in (("f", gf), ("g", gg)):
            for leaf in ("w", "b"):
                np.testing.assert_allclose(rev[f"{side}.{i}.{leaf}"].numpy(), np.asarray(g[leaf]),
                                           atol=1e-5, err_msg=f"{side}.{i}.{leaf}")


def test_a_block_saves_only_its_outputs(rng):
    """Between the forward and the backward a reversible sequence keeps two
    tensors a block, its outputs (none of f's and g's activations); the
    plain composition of the same blocks keeps more."""
    fs, gs = _modules(_weights(rng))
    x1 = torch.randn(4, D, requires_grad=True)
    x2 = torch.randn(4, D, requires_grad=True)

    def saved(run):
        packed = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t,
                                                      lambda t: t):
            a, b = run(fs, gs, x1, x2)
        return packed, a, b

    packed, a, b = saved(trev.reversible_sequence)
    assert len(packed) == 2 * BLOCKS
    assert any(t is a for t in packed) and any(t is b for t in packed), "last outputs not kept"
    assert all(t.shape == (4, D) for t in packed)
    plain, _, _ = saved(_plain)
    assert len(plain) > 2 * BLOCKS, len(plain)

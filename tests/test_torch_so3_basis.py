"""Port vs JAX: the SO(3) basis (`core/so3_basis`): real spherical
harmonics, Wigner-D matrices (a numpy copy) and the equivariant kernel
basis, in float64.

Tolerances: SH, Wigner-D, Q_J and get_basis within 1e-10 of the JAX
package's; the defining identities (Y(Rx) = D(R) Y(x), kron(D_a, D_b) Q =
Q D_J, kernel equivariance) at 1e-10 and 1e-8 as the JAX tests hold them.
JAX runs with x64 switched on per test and back off after
(tests/test_so3_basis.py explains why)."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu.core.so3_basis import basis as jbasis
from se3_equi_graph_registration_tpu.core.so3_basis import spherical_harmonics as jsh
from se3_equi_graph_registration_tpu_torch.core.so3_basis import basis as tbasis
from se3_equi_graph_registration_tpu_torch.core.so3_basis import spherical_harmonics as tsh
from se3_equi_graph_registration_tpu_torch.core.so3_basis import wigner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors and matrices: one torch thread and one BLAS thread
    (the Q_J SVDs), so that the lane's parallel workers do not
    oversubscribe the cores."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _dirs(rng, n):
    x = rng.standard_normal((n, 3))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_wigner_is_a_copy_of_the_jax_module():
    def code(path):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:]
        return ast.dump(tree)

    rel = os.path.join("core", "so3_basis", "wigner.py")
    assert code(os.path.join(ROOT, "se3_equi_graph_registration_tpu_torch", rel)) == \
        code(os.path.join(ROOT, "se3_equi_graph_registration_tpu", rel))


@pytest.mark.parametrize("l", range(5))
def test_spherical_harmonics_match_jax(rng, l):
    x = rng.standard_normal((64, 3)) * rng.uniform(0.1, 3.0, (64, 1))
    x[0] = (0.0, 0.0, 2.0)                          # the poles: φ from atan2(0, 0)
    x[1] = (0.0, 0.0, -1.0)
    ref = np.asarray(jsh.spherical_harmonics_xyz(l, jnp.asarray(x)))
    got = tsh.spherical_harmonics_xyz(l, T(x))
    assert got.dtype == torch.float64 and got.shape == (64, 2 * l + 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)
    th, ph = tsh.cartesian_to_angles(T(x))
    np.testing.assert_allclose(tsh.spherical_harmonics(l, th, ph).numpy(), ref, atol=1e-10)
    f32 = tsh.spherical_harmonics_xyz(l, T(x.astype(np.float32)))
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), ref, atol=1e-5)


def test_sh_closed_forms_and_the_wigner_identity(rng):
    """Y_0 and Y_1 in closed form; Y(Rx) = D(R) Y(x) for l ≤ 4."""
    x = _dirs(rng, 40)
    ys = tsh.all_spherical_harmonics(4, T(x))
    np.testing.assert_allclose(ys[0].numpy(), 0.5 / np.sqrt(np.pi), atol=1e-12)
    np.testing.assert_allclose(ys[1].numpy(), np.sqrt(3 / (4 * np.pi)) * x[:, [1, 2, 0]],
                               atol=1e-12)
    for l in range(5):
        R = wigner.rot(*rng.uniform(-np.pi, np.pi, 3))
        D = wigner.wigner_d_from_matrix(l, R)
        YR = tsh.spherical_harmonics_xyz(l, T(x @ R.T)).numpy()
        np.testing.assert_allclose(YR, ys[l].numpy() @ D.T, atol=1e-10)


@pytest.mark.parametrize("d_in,d_out,J", [(0, 0, 0), (1, 1, 0), (1, 1, 2), (2, 1, 2),
                                          (2, 2, 3), (1, 2, 1)])
def test_q_j_matches_jax_and_intertwines(rng, d_in, d_out, J):
    Q = tbasis.basis_transformation_Q_J(J, d_in, d_out)
    np.testing.assert_allclose(Q, jbasis.basis_transformation_Q_J(J, d_in, d_out), atol=1e-10)
    a, b, c = rng.uniform(-np.pi, np.pi, 3)
    K = np.kron(wigner.irr_repr(d_in, a, b, c), wigner.irr_repr(d_out, a, b, c))
    np.testing.assert_allclose(K @ Q, Q @ wigner.irr_repr(J, a, b, c), atol=1e-8)


def test_get_basis_matches_jax_with_its_keys_and_shapes(rng):
    """[64, 3] directions, the SH tests' shape (JAX's jitted SH compiles
    once for both); leading axes [8, 8] give the same kernels reshaped."""
    rel = rng.standard_normal((64, 3))
    ref = jbasis.get_basis(rel, 2)
    got = tbasis.get_basis(T(rel), 2)
    lead = tbasis.get_basis(T(rel.reshape(8, 8, 3)), 2)
    assert sorted(got) == sorted(ref) and len(got) == tbasis.num_basis_entries(2)
    for key, r in ref.items():
        d_in, d_out = map(int, key.split(","))
        assert got[key].dtype == torch.float64
        assert got[key].shape == (64, 2 * d_out + 1, 2 * d_in + 1, 2 * min(d_in, d_out) + 1)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(r), atol=1e-10)
        assert torch.equal(lead[key].reshape(got[key].shape), got[key])
    np.testing.assert_allclose(tbasis.get_basis(rel, 1)["1,1"].numpy(), ref["1,1"], atol=1e-10)


def test_basis_kernel_equivariance(rng):
    """K(R r) = D_out(R) K(r) D_in(R)ᵀ for every degree pair up to 2."""
    rel = rng.standard_normal((5, 3))
    a, b, c = 0.4, 0.8, -0.3
    R = wigner.rot(a, b, c)
    K1, K2 = tbasis.get_basis(T(rel), 2), tbasis.get_basis(T(rel @ R.T), 2)
    for key in K1:
        d_in, d_out = map(int, key.split(","))
        D_in, D_out = wigner.irr_repr(d_in, a, b, c), wigner.irr_repr(d_out, a, b, c)
        expect = np.einsum("ij,njkf,lk->nilf", D_out, K1[key].numpy(), D_in)
        np.testing.assert_allclose(K2[key].numpy(), expect, atol=1e-8)

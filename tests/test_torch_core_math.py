"""Port vs JAX: the pose algebra of `core/se3.py` and `core/quaternions.py`.

Tolerances: the deterministic functions within 1e-6 of JAX (both float32,
the same operations); the degrees of `pose_error` within 1e-6 relative;
`matrix_log_so3` at θ = π − 1e-4 in float64 (in float32 that angle does
not exist: the test says why), within 1e-6 of its scale π;
`center_and_normalize` within 1e-5: the means are summed in another order,
and a point near its cloud's mean scales that difference by 1/|p − μ|
(measured 1.7e-6). The random draws
cannot match JAX's (the two frameworks' generators give different
numbers): they are held to properness (orthonormal, det 1 within 1e-5),
to their angle and translation bounds, and to reproducibility from the
generator's seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu.core import quaternions as jq
from se3_equi_graph_registration_tpu.core import se3 as jse3
from se3_equi_graph_registration_tpu.data.synthetic import random_rotation
from se3_equi_graph_registration_tpu_torch.core import quaternions as tq
from se3_equi_graph_registration_tpu_torch.core import se3 as tse3


def _rotations(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([random_rotation(rng) for _ in range(n)]).astype(np.float32)


def _poses(seed, n):
    rng = np.random.default_rng(seed)
    P = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    P[:, :3, :3] = _rotations(seed, n)
    P[:, :3, 3] = rng.standard_normal((n, 3)).astype(np.float32)
    return P


def _axis_angle64(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _axis_angle(axis, angle):
    return _axis_angle64(axis, angle).astype(np.float32)


def test_geodesic_angle_and_pose_error_match_jax():
    a, b = _poses(0, 16), _poses(1, 16)
    np.testing.assert_allclose(
        tse3.rotation_geodesic_angle(torch.from_numpy(a[:, :3, :3]),
                                     torch.from_numpy(b[:, :3, :3])).numpy(),
        np.asarray(jse3.rotation_geodesic_angle(jnp.asarray(a[:, :3, :3]),
                                                jnp.asarray(b[:, :3, :3]))),
        rtol=0, atol=1e-6)
    rot, trans = tse3.pose_error(torch.from_numpy(a), torch.from_numpy(b))
    jrot, jtrans = jse3.pose_error(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), rtol=1e-6)
    np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans), rtol=1e-6)
    same = tse3.pose_error(torch.from_numpy(a), torch.from_numpy(a))
    assert torch.all(torch.isfinite(same[0])) and torch.all(same[1] == 0)


@pytest.fixture
def x64():
    """float64 in JAX for one test (flipped per test, never at module level)."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("case", ["random", "zero", "tiny"])
def test_matrix_log_so3_matches_jax(case):
    """Random rotations; the identity (zero residual); an angle of 1e-7
    (below the 1e-6 cut): exactly 0 there, with a finite gradient in the
    port (JAX's is NaN: the slope of arccos at 1)."""
    if case == "random":
        R = _rotations(2, 16)
    elif case == "zero":
        R = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    else:
        R = np.stack([_axis_angle([1, 2, 3], 1e-7)])
    got = tse3.matrix_log_so3(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, np.asarray(jse3.matrix_log_so3(jnp.asarray(R))),
                               rtol=0, atol=1e-6)
    if case != "random":
        assert np.all(got == 0)
        Rt = torch.from_numpy(R).requires_grad_(True)
        tse3.matrix_log_so3(Rt).sum().backward()
        assert torch.all(torch.isfinite(Rt.grad))


def test_matrix_log_so3_near_pi_matches_jax_in_float64(x64):
    """θ = π − 1e-4. In float32 the trace 1 + 2cos θ = −1 + 1e-8 rounds to
    −1, so θ reads as float32(π), sin θ as a rounding residue, and both
    packages return entries in the thousands; the angle exists only in
    float64, where both must give log R = θ·[axis]ₓ, the port within 1e-6
    (relative to the scale π) of JAX."""
    R = np.stack([_axis_angle64(ax, np.pi - 1e-4) for ax in ([1, 0, 0], [1, 2, 3], [0, 1, 1])])
    got = tse3.matrix_log_so3(torch.from_numpy(R)).numpy()
    ref = np.asarray(jse3.matrix_log_so3(jnp.asarray(R)))
    assert ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.pi)
    w = np.stack([got[:, 2, 1], got[:, 0, 2], got[:, 1, 0]], -1)
    np.testing.assert_allclose(np.linalg.norm(w, axis=-1), np.pi - 1e-4, rtol=1e-6)


@pytest.mark.parametrize("scalar_first", [True, False])
def test_quaternion_conversions_match_jax_on_all_branches(scalar_first):
    """Rotations that select each of Shepperd's four branches (trace > 0,
    then R00, R11, R22 dominant), and random ones."""
    R = np.concatenate([_rotations(3, 12)] + [
        np.stack([_axis_angle(ax, np.pi - 0.2)]) for ax in ([1, 0.1, 0.1], [0.1, 1, 0.1],
                                                            [0.1, 0.1, 1])])
    q = tq.rotation_matrix_to_quaternion(torch.from_numpy(R))
    jqt = np.asarray(jq.rotation_matrix_to_quaternion(jnp.asarray(R)))
    np.testing.assert_allclose(q.numpy(), jqt, rtol=0, atol=1e-6)
    qin = q.numpy() if scalar_first else np.roll(q.numpy(), -1, axis=-1)
    back = tq.quaternion_to_matrix(torch.from_numpy(qin), scalar_first=scalar_first).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jq.quaternion_to_matrix(jnp.asarray(qin), scalar_first=scalar_first)),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(back, R, atol=1e-5)
    m = R[12:]
    assert (np.trace(m, axis1=1, axis2=2) < 0).all()      # the three non-trace branches


def test_center_and_normalize_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 64, 3)).astype(np.float32)
    b = (rng.standard_normal((2, 64, 3)) + 3).astype(np.float32)
    got = tq.center_and_normalize(torch.from_numpy(a), torch.from_numpy(b))
    ref = jq.center_and_normalize(jnp.asarray(a), jnp.asarray(b))
    for g, r in zip(got, ref):      # the means sum in another order (module docstring)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)


def _proper(R):
    R = R.double()
    assert torch.allclose(R @ R.mT, torch.eye(3, dtype=torch.float64), atol=1e-5)
    assert abs(float(torch.det(R)) - 1.0) < 1e-5


@pytest.mark.parametrize("num_axis", [0, 1, 3])
def test_random_draws_are_proper_bounded_and_reproducible(num_axis):
    aug_r, aug_t = 0.25, 0.5
    draws = [tse3.random_pose(torch.Generator().manual_seed(s), num_axis, aug_r, aug_t)
             for s in range(32)]
    again = tse3.random_pose(torch.Generator().manual_seed(5), num_axis, aug_r, aug_t)
    assert torch.equal(draws[5], again)
    assert not torch.equal(draws[5], draws[6])
    for P in draws:
        _proper(P[:3, :3])
        assert torch.equal(P[3], torch.tensor([0.0, 0.0, 0.0, 1.0]))
        assert torch.all(P[:3, 3] >= 0) and torch.all(P[:3, 3] < aug_t)
        angle = float(tse3.rotation_geodesic_angle(torch.eye(3), P[:3, :3]))
        if num_axis == 0:
            assert torch.equal(P[:3, :3], torch.eye(3))
        elif num_axis == 1:      # one axis-aligned rotation by an angle in [0, 2π·aug_r)
            assert angle <= 2 * np.pi * aug_r + 1e-5
            assert int((P[:3, :3] - torch.eye(3)).abs().amax(0).gt(1e-7).sum()) <= 2
        else:                    # three such rotations composed
            assert angle <= 3 * 2 * np.pi * aug_r + 1e-5
    with pytest.raises(ValueError, match="num_axis"):
        tse3.rotation_matrix(torch.Generator(), 2, 1.0)


def test_random_rotation_composes_rx_ry_rz():
    """num_axis=3 composes Rx @ Ry @ Rz of the three drawn angles, the
    reference's order (the JAX package's `rotation_matrix`)."""
    g = torch.Generator().manual_seed(7)
    R = tse3.rotation_matrix(g, 3, 1.0)
    angles = torch.rand(3, generator=torch.Generator().manual_seed(7)) * (2 * np.pi)
    ref = np.eye(3)
    for axis, a in enumerate(angles.tolist()):
        ref = ref @ _axis_angle(np.eye(3)[axis], a).astype(np.float64)
    np.testing.assert_allclose(R.numpy(), ref, atol=1e-6)

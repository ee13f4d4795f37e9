"""Port vs JAX: the pose graph (`ops/pose_graph.py`) and the multiway tool
(`tools/multiway.py`), mirroring the six tests of tests/test_pose_graph.py
on the same seed-drawn inputs, plus every IRLS kernel, a finite Jacobian at
an exact residual, and the float32 pin of the solve.

Tolerances: fp32 on both sides, the same Gauss-Newton steps; rotations are
compared by ‖Ra − Rb‖_F/√2 and translations by max|Δt|, both within 1e-5
(measured ≤ 1e-6: the two libraries' 6V×6V LU solves round differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu.ops import pose_graph as jpg
from se3_equi_graph_registration_tpu.tools import multiway as jmultiway
from se3_equi_graph_registration_tpu_torch.core.se3 import matrix_exp_so3
from se3_equi_graph_registration_tpu_torch.ops import pose_graph as tpg
from se3_equi_graph_registration_tpu_torch.tools import multiway as tmultiway
from se3_equi_graph_registration_tpu_torch.utils.trajectory import (
    read_trajectory_log, write_trajectory_log)

TOL = 1e-5


def _circle_gt(V):
    R, t = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    for i in range(1, V):
        a = 2 * np.pi * i / V
        R.append(np.array([[np.cos(a), -np.sin(a), 0],
                           [np.sin(a), np.cos(a), 0],
                           [0, 0, 1]], np.float32))
        t.append(np.array([np.cos(a) - 1, np.sin(a), 0.1 * i], np.float32))
    return np.stack(R), np.stack(t)


def _rel(Rg, tg, i, j, rng=None, noise=0.0):
    Rr = Rg[i].T @ Rg[j]
    tr = Rg[i].T @ (tg[j] - tg[i])
    if noise:
        w = rng.standard_normal(3).astype(np.float32) * noise
        Rr = matrix_exp_so3(torch.from_numpy(w)).numpy() @ Rr
        tr = tr + rng.standard_normal(3).astype(np.float32) * noise
    return Rr.astype(np.float32), tr.astype(np.float32)


def _drifted_init(Rg, tg, edges_chain, rng, noise):
    R, t = [Rg[0]], [tg[0]]
    for i, _ in edges_chain:
        Rr, tr = _rel(Rg, tg, i, i + 1, rng, noise)
        t.append(t[-1] + R[-1] @ tr)
        R.append(R[-1] @ Rr)
    return np.stack(R), np.stack(t)


def _max_rot_deg(R, Rg):
    d = np.linalg.norm(R - Rg, axis=(1, 2)) / np.sqrt(2.0)
    return np.degrees(2 * np.arcsin(np.clip(d / 2, 0, 1))).max()


def _both(args, **kw):
    """(port R, port t, JAX R, JAX t) of optimize_pose_graph on the same
    numpy inputs, the port on the CPU; asserts they agree within TOL."""
    Rt, tt = tpg.optimize_pose_graph(*args, device="cpu", **kw)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    Rj, tj = jpg.optimize_pose_graph(*map(jnp.asarray, args), **jkw)
    Rt, tt, Rj, tj = Rt.numpy(), tt.numpy(), np.asarray(Rj), np.asarray(tj)
    dR = (np.linalg.norm(Rt - Rj, axis=(1, 2)) / np.sqrt(2)).max()
    dt = np.abs(tt - tj).max()
    assert dR <= TOL and dt <= TOL, (dR, dt)
    return Rt, tt, Rj, tj


def _circle_graph(rng, V, noise):
    Rg, tg = _circle_gt(V)
    chain = [(i, i + 1) for i in range(V - 1)]
    edges = np.array(chain + [(0, V - 1), (2, 8), (4, 10)], np.int32)
    R_rel, t_rel = map(np.stack, zip(*[_rel(Rg, tg, i, j, rng, noise) for i, j in edges]))
    R0, t0 = _drifted_init(Rg, tg, chain, rng, 0.03)
    return Rg, tg, (R0, t0, edges, R_rel, t_rel)


@pytest.fixture(scope="module")
def drift():
    """The noisy 12-fragment circle of test_loop_closure_fixes_drift."""
    return _circle_graph(np.random.default_rng(20240518), 12, 0.01)


def test_exact_measurements_exact_recovery(rng):
    Rg, tg, args = _circle_graph(rng, 12, 0.0)
    R, t, _, _ = _both(args, iters=15)
    assert _max_rot_deg(R, Rg) < 1e-3
    assert np.abs(t - tg).max() < 1e-5
    np.testing.assert_allclose(R[0], Rg[0], atol=1e-6)


def test_loop_closure_fixes_drift(drift):
    Rg, tg, args = drift
    R0, t0 = args[:2]
    R, t, _, _ = _both(args, iters=15)
    assert np.abs(t - tg).max() < np.abs(t0 - tg).max() / 5
    assert _max_rot_deg(R, Rg) < _max_rot_deg(R0, Rg)


@pytest.mark.parametrize("robust", ["huber", "cauchy", "geman", "welsch"])
def test_each_irls_kernel_matches_jax(drift, robust):
    """The GNC-annealed IRLS rounds under every kernel, and pure MAD scaling
    (robust_anneal=0) under geman: the midpoint median, the MAD scale and
    the fp32 annealing schedule as JAX computes them."""
    _both(drift[2], iters=15, robust=robust)
    if robust == "geman":
        _both(drift[2], iters=15, robust=robust, robust_anneal=0.0)


def test_edge_weights_downweight_bad_closure(rng):
    V = 8
    Rg, tg = _circle_gt(V)
    chain = [(i, i + 1) for i in range(V - 1)]
    edges = np.array(chain + [(0, V - 1), (1, 5)], np.int32)
    rels = [_rel(Rg, tg, i, j) for i, j in edges]
    bad = list(rels[-1])
    bad[1] = bad[1] + np.float32([0.5, -0.4, 0.3])
    rels[-1] = tuple(bad)
    R_rel, t_rel = map(np.stack, zip(*rels))
    R0, t0 = _drifted_init(Rg, tg, chain, rng, 0.02)
    w_uni = np.ones(len(edges), np.float32)
    w_down = w_uni.copy()
    w_down[-1] = 1e-4
    args = (R0, t0, edges, R_rel, t_rel)
    _, t_uni, _, _ = _both(args, weights=w_uni, iters=15)
    _, t_dn, _, _ = _both(args, weights=w_down, iters=15)
    assert np.abs(t_dn - tg).max() < 1e-3
    assert np.abs(t_uni - tg).max() > 5 * np.abs(t_dn - tg).max()


def test_trajectory_wrapper(rng):
    """The 4x4 wrapper against the jitted JAX wrapper, and the gt.log schema."""
    V = 6
    Rg, tg = _circle_gt(V)
    poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    poses[:, :3, :3], poses[:, :3, 3] = Rg, tg
    chain = [(i, i + 1) for i in range(V - 1)]
    edges = np.array(chain + [(0, V - 1)], np.int32)
    rel = np.stack([np.linalg.inv(poses[i]) @ poses[j] for i, j in edges])
    init = poses.copy()
    init[1:, :3, 3] += rng.standard_normal((V - 1, 3)).astype(np.float32) * 0.05
    ref = np.asarray(jax.jit(lambda p: jpg.optimize_trajectory(p, edges, rel, iters=10))(
        jnp.asarray(init)))
    out = tpg.optimize_trajectory(init, edges, rel, iters=10, device="cpu")
    assert out.dtype == torch.float32 and out.shape == (V, 4, 4)
    out = out.numpy()
    np.testing.assert_allclose(out, ref, atol=TOL)
    np.testing.assert_allclose(out, poses, atol=1e-4)
    np.testing.assert_array_equal(out[:, 3], np.tile([0, 0, 0, 1], (V, 1)).astype(np.float32))


def test_robust_kernel_repairs_corrupted_chain_edge():
    V = 4
    Rg = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
    edges = np.array([(0, 1), (1, 2), (2, 3), (0, 3), (0, 2)], np.int32)
    t_rel = np.array([[1, 0, 0], [1.3, 0, 0], [1, 0, 0], [3, 0, 0], [2, 0, 0]], np.float32)
    R_rel = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
    t0 = np.array([[0, 0, 0], [1, 0, 0], [2.3, 0, 0], [3.3, 0, 0]], np.float32)
    t_true = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], np.float32)
    args = (Rg, t0, edges, R_rel, t_rel)
    _, t_rob, _, _ = _both(args, robust="geman", iters=20)
    np.testing.assert_allclose(t_rob, t_true, atol=1e-3)
    _, t_lsq, _, _ = _both(args, iters=20)
    assert np.abs(t_lsq - t_true).max() > 0.02
    with pytest.raises(ValueError, match="unknown robust"):
        tpg.optimize_pose_graph(*args, robust="bogus", device="cpu")


def test_multiway_tool_log_round_trip(tmp_path):
    """tools/multiway.main on the CPU against the JAX tool: gt.log in
    (odometry + a corrupted link + closures), optimized absolute poses out.
    Both write 8 decimals, so the logs agree within 1e-5 + 1e-8."""
    V = 5
    Rg, tg = _circle_gt(V)
    gt = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    gt[:, :3, :3], gt[:, :3, 3] = Rg, tg
    odo = {f"{i}_{i + 1}": np.linalg.inv(gt[i]) @ gt[i + 1] for i in range(V - 1)}
    odo["1_2"] = odo["1_2"].copy()
    odo["1_2"][:3, 3] += [0.25, 0, 0]
    closures = {f"{i}_{i + 2}": np.linalg.inv(gt[i]) @ gt[i + 2] for i in range(V - 2)}
    closures[f"0_{V - 1}"] = np.linalg.inv(gt[0]) @ gt[V - 1]
    write_trajectory_log(str(tmp_path / "odo.log"), odo)
    write_trajectory_log(str(tmp_path / "loops.log"), closures)
    logs = ["--log", str(tmp_path / "odo.log"), "--log", str(tmp_path / "loops.log")]
    tmultiway.main(logs + ["--out", str(tmp_path / "opt.log"), "--device", "cpu"])
    jmultiway.main(logs + ["--out", str(tmp_path / "ref.log")])
    out = read_trajectory_log(str(tmp_path / "opt.log"))
    ref = read_trajectory_log(str(tmp_path / "ref.log"))
    assert len(out) == V and out.keys() == ref.keys()
    for k in range(V):
        T = out[f"0_{k}"]
        np.testing.assert_allclose(T, ref[f"0_{k}"], atol=TOL + 1e-8)
        assert np.abs(T[:3, 3] - tg[k]).max() < 1e-3, k
        assert np.linalg.norm(T[:3, :3] - Rg[k]) < 1e-3, k
    # the in-memory entry point: numpy in and out, float32 poses
    poses = tmultiway.optimize_logs([odo, closures], device="cpu")
    assert all(p.dtype == np.float32 and p.shape == (4, 4) for p in poses.values())
    with pytest.raises(ValueError, match="no edges"):
        tmultiway.optimize_logs([{}], device="cpu")


def test_jacobian_is_finite_at_an_exact_residual():
    """Gauss-Newton takes its Jacobian at δ = 0 every step, where a residual
    can be exactly 0 (exact measurements at the optimum). The log map's and
    the exp map's guarded branches keep it finite there: at R = I the
    derivative of _log_so3_vee(exp(w)) is the identity, as JAX's; and a
    graph started on its exact optimum stays there with finite poses."""
    jac = torch.func.jacfwd(lambda w: tpg._log_so3_vee(matrix_exp_so3(w)))(torch.zeros(3))
    ref = jax.jacfwd(lambda w: jpg._log_so3_vee(jpg.matrix_exp_so3(w)))(jnp.zeros(3))
    assert torch.isfinite(jac).all()
    np.testing.assert_allclose(jac.numpy(), np.asarray(ref), atol=1e-7)
    np.testing.assert_allclose(jac.numpy(), np.eye(3), atol=1e-7)
    R0 = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    t0 = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
    edges = np.array([(0, 1), (1, 2), (0, 2)], np.int32)
    t_rel = np.array([[1, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
    R_rel = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    for robust in (None, "geman"):
        R, t = tpg.optimize_pose_graph(R0, t0, edges, R_rel, t_rel, iters=3, robust=robust,
                                       device="cpu")
        assert torch.isfinite(R).all() and torch.isfinite(t).all()
        np.testing.assert_allclose(t.numpy(), t0, atol=1e-6)
        np.testing.assert_allclose(R.numpy(), R0, atol=1e-6)


def test_the_solve_runs_in_full_fp32(drift, monkeypatch):
    """Every product of the optimizer (the retraction, the residual
    einsums, JᵀJ, Jᵀr) and the solve run at "highest" float32 matmul
    precision while the caller has "high" (TF32 allowed), which comes back
    afterwards: beside the 1e8 gauge prior, TF32 in JᵀJ wrecks the solve."""
    from torch.overrides import TorchFunctionMode

    watched = {torch.matmul, torch.mm, torch.bmm, torch.einsum, torch.Tensor.matmul,
               torch.Tensor.__matmul__, torch.Tensor.mm, torch.Tensor.bmm,
               torch.linalg.solve}
    seen = []

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in watched:
                seen.append((getattr(func, "__name__", str(func)),
                             torch.get_float32_matmul_precision()))
            return func(*args, **(kwargs or {}))

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with Spy():
            tpg.optimize_pose_graph(*drift[2], iters=2, robust="geman", device="cpu")
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prev)
    names = {n for n, _ in seen}
    assert {"linalg_solve", "einsum", "matmul"} <= names, names
    assert {p for _, p in seen} == {"highest"}, seen
    assert after == "high"

"""Port vs JAX: the loss families, `total_loss`, the damped SVD backward,
the pose helpers, the metrics' summary and the numpy data pipeline, on the
same numpy inputs; plus the gradient traps the reference defuses (an exactly
aligned pose, a degenerate Kabsch H, an empty correspondence mask).

Tolerances: fp32 on both sides, summation orders differ. Values to 1e-6
relative (1e-5 for the standardized similarity loss, whose std divides),
gradients to 1e-5 of each tensor's scale (1e-4 through the Kabsch solve);
the SVD backward to 1e-4 of its scale (its F matrix divides by σ²
differences), 1e-3 near a degenerate spectrum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu.core import se3 as jse3
from se3_equi_graph_registration_tpu.data import pipeline as jpipe
from se3_equi_graph_registration_tpu.models.pose_head import RegistrationOutputs as JOut
from se3_equi_graph_registration_tpu.ops import kabsch as jkabsch
from se3_equi_graph_registration_tpu.ops.svd3 import svd3 as jsvd3
from se3_equi_graph_registration_tpu.train import losses as jl
from se3_equi_graph_registration_tpu.train import metrics as jmetrics
from se3_equi_graph_registration_tpu_torch.core import se3 as tse3
from se3_equi_graph_registration_tpu_torch.data import pipeline as tpipe
from se3_equi_graph_registration_tpu_torch.data.synthetic import random_rotation
from se3_equi_graph_registration_tpu_torch.models.pose_head import RegistrationOutputs as TOut
from se3_equi_graph_registration_tpu_torch.ops import kabsch as tkabsch
from se3_equi_graph_registration_tpu_torch.ops.svd3 import svd3 as tsvd3
from se3_equi_graph_registration_tpu_torch.train import losses as tl
from se3_equi_graph_registration_tpu_torch.train import metrics as tmetrics

B, N, C, TOPK = 2, 64, 8, 16


def _pose(rng):
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = random_rotation(rng)
    p[:3, 3] = rng.standard_normal(3)
    return p


@pytest.fixture(scope="module")
def outputs():
    rng = np.random.default_rng(9)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    scores = f(B, TOPK)
    scores[0, :3] = 0.0           # exact zeros: a dead-ReLU score MLP's output
    arrs = dict(R=np.stack([_pose(rng)[:3, :3] for _ in range(B)]), t=f(B, 3),
                scores=scores, top_labels=(rng.uniform(size=(B, TOPK)) < 0.6).astype(np.float32),
                top_indices=np.zeros((B, TOPK), np.int32), similarity=f(B, N),
                raw_similarity=f(B, N), h_src=f(B, N, C), x_src=f(B, N, 3),
                h_tgt=f(B, N, C), x_tgt=f(B, N, 3), weights=np.zeros((B, N), np.float32))
    gt = np.stack([_pose(rng) for _ in range(B)])
    labels = (rng.uniform(size=(B, N)) < 0.7).astype(np.float32)
    return arrs, gt, labels


DIFF = ("R", "t", "scores", "similarity", "raw_similarity", "h_src", "x_src", "h_tgt", "x_tgt")


def _both(arrs, gt, labels, weights):
    """(JAX total_loss breakdown and its gradients, the port's)."""
    def jfun(d):
        out = JOut(**{**arrs, **d})
        return jl.total_loss(out, jnp.asarray(gt), jnp.asarray(labels), weights).total
    jd = {k: jnp.asarray(arrs[k]) for k in DIFF}
    jlb = jl.total_loss(JOut(**{**arrs, **jd}), jnp.asarray(gt), jnp.asarray(labels), weights)
    jg = jax.grad(jfun)(jd)
    td = {k: torch.tensor(arrs[k], requires_grad=k in DIFF) for k in arrs}
    tlb = tl.total_loss(TOut(**td), torch.tensor(gt), torch.tensor(labels),
                        tl.LossWeights(*weights))
    tlb.total.backward()
    return jlb, jg, tlb, {k: td[k].grad for k in DIFF}


@pytest.mark.parametrize("weights", [jl.LossWeights(), jl.LossWeights(rot=0.0, trans=0.0, equi=1.0)],
                         ids=["3dmatch", "kitti"])
def test_total_loss_and_its_gradients_match_jax(outputs, weights):
    jlb, jg, tlb, tg = _both(*outputs, weights)
    for name in jl.LossBreakdown._fields:
        ref = float(getattr(jlb, name))
        tol = 1e-5 if name in ("sim", "total") else 1e-6
        assert abs(float(getattr(tlb, name).detach()) - ref) <= tol * max(abs(ref), 1e-6), name
    for k in DIFF:
        ref = np.asarray(jg[k])
        np.testing.assert_allclose(tg[k].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


def test_each_loss_family_matches_jax(outputs):
    arrs, gt, labels = outputs
    J, Tt = (lambda k: jnp.asarray(arrs[k])), (lambda k: torch.tensor(arrs[k]))
    pairs = [
        (jl.bce_with_logits(J("scores"), J("top_labels")),
         tl.bce_with_logits(Tt("scores"), Tt("top_labels"))),
        (jl.similarity_consistency_loss(J("similarity"), J("raw_similarity")),
         tl.similarity_consistency_loss(Tt("similarity"), Tt("raw_similarity"))),
        (jl.egnn_equi_loss(J("h_src"), J("x_src"), J("h_tgt"), J("x_tgt"), gt, labels),
         tl.egnn_equi_loss(Tt("h_src"), Tt("x_src"), Tt("h_tgt"), Tt("x_tgt"),
                           torch.tensor(gt), torch.tensor(labels))),
        *zip(jl.masked_point_and_feature_loss(J("R"), J("t"), J("h_src"), J("x_src"),
                                              J("h_tgt"), J("x_tgt"), labels),
             tl.masked_point_and_feature_loss(Tt("R"), Tt("t"), Tt("h_src"), Tt("x_src"),
                                              Tt("h_tgt"), Tt("x_tgt"), torch.tensor(labels))),
        *zip(jl.pose_loss(J("R"), J("t"), gt),
             tl.pose_loss(Tt("R"), Tt("t"), torch.tensor(gt))),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # the std is the unbiased one (ddof=1), not jnp's default
    s = torch.tensor(arrs["similarity"])
    assert float(tl.similarity_consistency_loss(s, 2 * s + 1)) < 1e-10


def test_pose_loss_at_an_exactly_aligned_pose_has_a_finite_gradient():
    gt = torch.eye(4).repeat(2, 1, 1)
    gt[:, :3, 3] = torch.tensor([0.3, -0.2, 0.5])
    R = torch.eye(3).repeat(2, 1, 1).requires_grad_()
    t = gt[:, :3, 3].clone().requires_grad_()
    rot, trans = tl.pose_loss(R, t, gt)
    (rot.sum() + trans.sum()).backward()
    assert torch.all(torch.isfinite(R.grad)) and torch.all(torch.isfinite(t.grad))
    assert float(rot.detach().max()) < 2e-3            # the clip's √(2·1e-6) bias


@pytest.mark.parametrize("degenerate", [False, True], ids=["generic", "H≈εI"])
def test_svd3_backward_matches_the_jax_vjp(degenerate):
    """Generic H: the VJP of (U, S, Vh) under random cotangents. H ≈ εI (exact,
    and perturbed by 1e-9 and 1e-7): the singular vectors are arbitrary
    there, so the comparison goes through the rotation R = V·Uᵀ of the
    Kabsch solve, which is well defined; torch.linalg.svd's own backward
    gives NaN at H = εI."""
    rng = np.random.default_rng(2)
    H = rng.standard_normal((4, 3, 3)).astype(np.float32)
    if degenerate:
        H = np.broadcast_to(1e-6 * np.eye(3, dtype=np.float32), (4, 3, 3)).copy()
        H[1] += 1e-9 * rng.standard_normal((3, 3)).astype(np.float32)
        H[2] += 1e-7 * rng.standard_normal((3, 3)).astype(np.float32)
        W = rng.standard_normal((4, 3, 3)).astype(np.float32)
        f = lambda h: jnp.sum(jkabsch._rotation_from_H_svd(h) * W)
        g = lambda h: (tkabsch._rotation_from_H_svd(h) * torch.tensor(W)).sum()
    else:
        cot = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3, 3), (4, 3), (4, 3, 3))]
        f = lambda h: sum(jnp.sum(o * c) for o, c in zip(jsvd3(h), cot))
        g = lambda h: sum((o * torch.tensor(c)).sum() for o, c in zip(tsvd3(h), cot))
    ref = np.asarray(jax.grad(f)(jnp.asarray(H)))
    th = torch.tensor(H, requires_grad=True)
    g(th).backward()
    assert np.all(np.isfinite(ref)) and torch.all(torch.isfinite(th.grad))
    # near-degenerate spectra amplify the two LAPACKs' fp32 differences by
    # the damped 1/(σj² − σi²): 1e-3 of the scale there (measured 1.2e-4)
    tol = 1e-3 if degenerate else 1e-4
    np.testing.assert_allclose(th.grad.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("solver", ["svd", "quaternion"])
def test_kabsch_gradients_finite_with_an_empty_mask_and_match_jax(solver):
    rng = np.random.default_rng(4)
    src = rng.uniform(-1, 1, (2, 32, 3)).astype(np.float32)
    tgt = (src @ random_rotation(rng).T + 0.1
           + 0.1 * rng.standard_normal((2, 32, 3))).astype(np.float32)
    scores = rng.standard_normal((2, 32)).astype(np.float32)
    mask = np.ones((2, 32), np.float32)
    mask[1] = 0.0                                      # pair 1: no correspondence

    def jfun(s, a, b):
        R, t = jkabsch.kabsch_weighted(a, b, jkabsch.masked_softmax(s, mask), solver=solver)
        return jnp.sum(R * R[::-1]) + jnp.sum(t)
    jg = jax.grad(jfun, argnums=(0, 1, 2))(jnp.asarray(scores), jnp.asarray(src),
                                          jnp.asarray(tgt))
    ts, ta, tb = (torch.tensor(v, requires_grad=True) for v in (scores, src, tgt))
    R, t = tkabsch.kabsch_weighted(ta, tb, tkabsch.masked_softmax(ts, torch.tensor(mask)),
                                   solver=solver)
    assert torch.equal(R[1], torch.eye(3)) and torch.equal(t[1], torch.zeros(3))
    (torch.sum(R * R.flip(0)) + torch.sum(t)).backward()
    for got, ref in zip((ts.grad, ta.grad, tb.grad), jg):
        ref = np.asarray(ref)
        assert torch.all(torch.isfinite(got))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
        assert float(got[1].abs().max()) == 0.0


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(6)
    a, b = np.stack([_pose(rng) for _ in range(3)]), np.stack([_pose(rng) for _ in range(3)])
    pts = rng.standard_normal((3, 10, 3)).astype(np.float32)
    ta, tb = torch.tensor(a), torch.tensor(b)
    close = lambda got, ref: np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                                        rtol=0, atol=1e-5)
    close(tse3.transform(torch.tensor(pts), ta), jse3.transform(pts, a))
    close(tse3.concatenate(ta, tb), jse3.concatenate(a, b))
    close(tse3.inverse(ta), jse3.inverse(a))
    close(tse3.integrate_trans(ta[:, :3, :3], ta[:, :3, 3:]),
          jse3.integrate_trans(a[:, :3, :3], a[:, :3, 3:]))
    R, t = tse3.decompose_trans(ta)
    close(tse3.integrate_trans(R, t), a)


def test_metrics_summary_and_f1_match_jax():
    rng = np.random.default_rng(8)
    rot, trans, rec, prec = (rng.uniform(0, 1, 20) for _ in range(4))
    assert tmetrics.summarize(rot, trans, rec, prec) == jmetrics.summarize(rot, trans, rec, prec)
    np.testing.assert_allclose(
        tmetrics.f1_score(torch.tensor(prec), torch.tensor(rec)).numpy(),
        np.asarray(jmetrics.f1_score(jnp.asarray(prec), jnp.asarray(rec))), rtol=1e-6)


def test_pipeline_copy_batches_like_the_jax_package():
    rng = np.random.default_rng(1)
    data = [tuple(rng.standard_normal(s).astype(np.float32) for s in
                  ((n, 2), (n,), (n, 3), (n, 3), (n, 4), (n, 4), (4, 4)))
            for n in (30, 30, 25, 30, 28, 30, 30)]
    for a, b in zip(tpipe.collate_min_clip(data[:3]), jpipe.collate_min_clip(data[:3])):
        np.testing.assert_array_equal(a, b)
    same = [d for d in data if len(d[1]) == 30]
    got = list(tpipe.PairLoader(same, 2, seed=3, num_workers=2))
    ref = list(jpipe.PairLoader(same, 2, seed=3, num_workers=2))
    assert len(got) == len(ref) == len(same) // 2
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)

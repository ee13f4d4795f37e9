"""Port vs JAX: the descriptor stage of the checkpoint-free pipeline —
eig3, both normal estimators, the gather FPFH, and the fused SPFH (B5),
whose plain version is held against `spfh_pallas` run in interpret mode.

Tolerances:
- eig3: |v_port · v_jax| ≥ 1 − 1e-5 (sign is arbitrary); the isotropic and
  zero fallbacks are +z exactly; collinear spectra (a degenerate eigenspace)
  give a unit vector ⟂ the dominant axis on both sides.
- normals: max |Δ| ≤ 1e-4 after orientation (fp32 sums in other orders,
  moments from an elementwise sum against the reference's matmul).
- FPFH from one SPFH (fpfh_from_spfh): the reference's own bar
  (`tests/test_fpfh.py`), rtol 1e-5, atol 1e-3. Where the two sides bin
  the angles themselves, an edge within fp noise of a bin boundary may fall
  in the next bin. That moves a whole count in its center's row and in the
  ~K rows that average that center (~2K + 2 entries, 0.4% of them at
  N = 512, K = 40), so there 99% of the FPFH entries meet the bar.
- SPFH: at most 1e-3 of the edges in another bin, other centers within
  1e-5 relative; distances within 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu.ops import eig3 as jeig3
from se3_equi_graph_registration_tpu.ops import fpfh as jfpfh
from se3_equi_graph_registration_tpu.ops import morton as jmorton
from se3_equi_graph_registration_tpu.ops.pallas.spfh_kernel import spfh_pallas
from se3_equi_graph_registration_tpu_torch.ops import eig3 as teig3
from se3_equi_graph_registration_tpu_torch.ops import fpfh as tfpfh
from se3_equi_graph_registration_tpu_torch.ops.kernels import spfh as tspfh


@pytest.fixture(scope="module")
def window_cloud():
    """A 512-point sample of a smooth random surface, Hilbert-sorted, with
    its k=40 window graph (tile 128, window 256) from the JAX package."""
    rng = np.random.default_rng(0)
    gx, gy = np.meshgrid(np.linspace(-1, 1, 24), np.linspace(-1, 1, 24))
    z = np.zeros_like(gx)
    for _ in range(5):
        a = rng.uniform(0.1, 0.3)
        b, p, q = rng.uniform(1, 4), rng.uniform(1, 4), rng.uniform(0, 6)
        z += a * np.sin(b * gx + q) * np.cos(p * gy)
    pts = np.stack([gx, gy, z], -1).reshape(-1, 3).astype(np.float32)
    pts = pts + rng.standard_normal(pts.shape).astype(np.float32) * 0.002
    x = jnp.asarray(pts[np.random.default_rng(3).permutation(len(pts))[:512]])
    _, xs, _ = jmorton.sort_by_curve(jnp.zeros((512, 0)), x)
    nbr = jmorton.knn_graph_window(xs, 40, tile=128, window=256)
    return np.array(xs), np.array(nbr)


def _spectra(kind, rng, n=64):
    """Symmetric PSD matrices [n, 3, 3] with the named spectrum."""
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    lam = {"random": rng.uniform(0.1, 2.0, (n, 3)),
           "planar": np.stack([rng.uniform(1, 2, n), rng.uniform(1, 2, n),
                               rng.uniform(1e-4, 1e-3, n)], -1),
           "collinear": np.stack([rng.uniform(1, 2, n), np.full(n, 1e-7), np.full(n, 1e-7)], -1),
           "isotropic": np.ones((n, 3)),
           "zero": np.zeros((n, 3))}[kind]
    return np.einsum("nab,nb,ncb->nac", q, lam, q).astype(np.float32), q


@pytest.mark.parametrize("kind", ["random", "planar", "collinear", "isotropic", "zero"])
def test_eig3_matches_jax(kind):
    A, q = _spectra(kind, np.random.default_rng(1))
    ref = np.asarray(jeig3.smallest_eigvec_sym3(jnp.asarray(A)))
    got = teig3.smallest_eigvec_sym3(torch.from_numpy(A)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    if kind in ("isotropic", "zero"):
        np.testing.assert_array_equal(got, np.broadcast_to([0.0, 0.0, 1.0], got.shape))
        np.testing.assert_array_equal(ref, got)
    elif kind == "collinear":
        dominant = q[:, :, 0]
        assert np.abs(np.sum(got * dominant, -1)).max() < 1e-3
        assert np.abs(np.sum(ref * dominant, -1)).max() < 1e-3
    else:
        assert np.abs(np.sum(got * ref, -1)).min() >= 1 - 1e-5


@pytest.mark.parametrize("orient", ["viewpoint", "local"])
def test_gather_normals_match_jax(window_cloud, orient):
    xs, nbr = window_cloud
    ref = np.asarray(jfpfh.estimate_normals(jnp.asarray(xs), orient=orient,
                                            nbr=jnp.asarray(nbr[:, :20])))
    got = tfpfh.estimate_normals(torch.from_numpy(xs), orient=orient,
                                 nbr=torch.from_numpy(nbr[:, :20])).numpy()
    assert np.abs(got - ref).max() <= 1e-4


def test_window_normals_match_jax(window_cloud):
    xs, nbr = window_cloud
    ref = np.asarray(jfpfh.estimate_normals_window(jnp.asarray(xs), jnp.asarray(nbr[:, :20]),
                                                   128, 256))
    got = tfpfh.estimate_normals_window(torch.from_numpy(xs), torch.from_numpy(nbr[:, :20]))
    assert np.abs(got.numpy() - ref).max() <= 1e-4


def test_normals_from_own_knn_match_jax(window_cloud):
    """nbr=None: the dense k-NN inside, viewpoint orientation (the ICP use)."""
    xs, _ = window_cloud
    ref = np.asarray(jfpfh.estimate_normals(jnp.asarray(xs), k=16))
    got = tfpfh.estimate_normals(torch.from_numpy(xs), k=16).numpy()
    assert np.abs(got - ref).max() <= 1e-4


def _share_within_bar(got, ref):
    """Share of the FPFH entries that meet rtol 1e-5, atol 1e-3."""
    return np.isclose(got, ref, rtol=1e-5, atol=1e-3).mean()


def test_gather_fpfh_matches_jax(window_cloud):
    """The atan2 formulation: an edge within fp noise of a bin boundary may
    fall in the next bin on one side (the two libraries round the Darboux
    products and atan2 differently); 99% of the entries meet the bar."""
    xs, nbr = window_cloud
    nrm = jfpfh.estimate_normals(jnp.asarray(xs), orient="local", nbr=jnp.asarray(nbr[:, :20]))
    ref = np.asarray(jfpfh.fpfh(jnp.asarray(xs), nrm, nbr=jnp.asarray(nbr)))
    got = tfpfh.fpfh(torch.from_numpy(xs), torch.from_numpy(np.array(nrm)),
                     nbr=torch.from_numpy(nbr)).numpy()
    assert _share_within_bar(got, ref) >= 0.99


def _counts(spfh, dist):
    """Integer bin counts [N, 33] back from SPFH rows scaled to 100 per channel."""
    valid = (dist > 0).sum(-1, keepdims=True)
    return np.rint(spfh * valid / 100.0).astype(np.int64)


@pytest.mark.parametrize("accurate", [True, False], ids=["accurate", "fast"])
def test_spfh_plain_matches_pallas_interpret(window_cloud, accurate):
    """B5's plain version against the Pallas kernel. The interpreter runs
    the kernel's gather matmul in fp32 at either precision, so the fast
    mode's reference gets the bf16-rounded inputs that a DEFAULT-precision
    TPU matmul would hand the kernel. Both sides bin θ by the same sector
    tests, but XLA rounds the Darboux products its own way, so an edge
    within fp noise of a boundary (the ±π seam: w·n_t ≈ 0) may land in the
    next bin: at most 1e-3 of the edges, and every other center equal."""
    xs, nbr = window_cloud
    nrm = np.array(jfpfh.estimate_normals_window(jnp.asarray(xs), jnp.asarray(nbr[:, :20]),
                                                   128, 256))
    jx, jn = xs, nrm
    if not accurate:
        jx = tspfh.round_bf16(torch.from_numpy(xs)).numpy()
        jn = tspfh.round_bf16(torch.from_numpy(nrm)).numpy()
    s_ref, d_ref = (np.array(a) for a in spfh_pallas(
        jnp.asarray(jx), jnp.asarray(jn), jnp.asarray(nbr), 256, tile_t=128, interpret=True,
        accurate=accurate))
    s_got, d_got = tspfh.spfh(torch.from_numpy(xs)[None], torch.from_numpy(nrm)[None],
                              torch.from_numpy(nbr)[None], 128, 256, accurate=accurate)
    s_got, d_got = s_got[0].numpy(), d_got[0].numpy()
    np.testing.assert_allclose(d_got, d_ref, rtol=1e-6, atol=0)
    assert np.all((d_got == 0).sum(axis=1) == 1)                   # the self pair only
    dc = np.abs(_counts(s_got, d_got) - _counts(s_ref, d_ref))
    assert dc.sum() / 2 <= 1e-3 * d_got.size, dc.sum() / 2          # edges in another bin
    same = dc.sum(-1) == 0
    np.testing.assert_allclose(s_got[same], s_ref[same], rtol=1e-5, atol=0)

    # the neighbor accumulation on the same SPFH, at the reference's bar
    f_ref = np.asarray(jfpfh.fpfh_from_spfh(jnp.asarray(s_ref), jnp.asarray(nbr),
                                            jnp.asarray(d_ref), 128, 256))
    f_got = tfpfh.fpfh_from_spfh(torch.from_numpy(s_ref), torch.from_numpy(nbr),
                                 torch.from_numpy(d_ref)).numpy()
    np.testing.assert_allclose(f_got, f_ref, rtol=1e-5, atol=1e-3)
    if accurate:   # the fused path reproduces the gather FPFH, as in the reference
        f_fused = tfpfh.fpfh_from_spfh(torch.from_numpy(s_got), torch.from_numpy(nbr),
                                       torch.from_numpy(d_got)).numpy()
        f_gather = tfpfh.fpfh(torch.from_numpy(xs), torch.from_numpy(nrm),
                              nbr=torch.from_numpy(nbr)).numpy()
        assert _share_within_bar(f_fused, f_gather) >= 0.99


def test_descriptor_reductions_use_no_matmul(window_cloud):
    """The normals' moments and the FPFH neighbor sums are elementwise
    products summed over an axis: no matmul, so TF32 on the card
    (`torch.backends.cuda.matmul.allow_tf32`) cannot round them."""
    from torch.overrides import TorchFunctionMode

    matmuls = {torch.matmul, torch.mm, torch.bmm, torch.einsum, torch.tensordot,
               torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.mm,
               torch.Tensor.bmm, torch.nn.functional.linear}
    seen = []

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in matmuls:
                seen.append(func)
            return func(*args, **(kwargs or {}))

    xs, nbr = (torch.from_numpy(a) for a in window_cloud)
    with Spy():
        nrm = tfpfh.estimate_normals_window(xs, nbr[:, :20])
        s, d = tspfh.spfh(xs[None], nrm[None], nbr[None], 128, 256)
        tfpfh.fpfh_from_spfh(s, nbr[None], d)
    assert not seen, seen


def test_voxel_downsample_and_native_extractor_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 1, size=(3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(tfpfh.voxel_downsample(pts, 0.25),
                                  jfpfh.voxel_downsample(pts, 0.25))
    # a smooth surface facing the origin viewpoint
    xy = rng.uniform(-1, 1, size=(3000, 2))
    pts = np.concatenate([xy, 2.0 + 0.2 * np.sin(2 * xy[:, :1]) * np.cos(3 * xy[:, 1:])],
                         -1).astype(np.float32)
    p_ref, f_ref = jfpfh.extract_fpfh_native(pts, voxel_size=0.05, k_normals=16, k_fpfh=24)
    p_got, f_got = tfpfh.extract_fpfh_native(pts, voxel_size=0.05, k_normals=16, k_fpfh=24,
                                             device="cpu")
    np.testing.assert_array_equal(p_got, p_ref)
    assert _share_within_bar(f_got, f_ref) >= 0.99

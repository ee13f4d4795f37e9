"""The SPFH kernels' own sources on the CPU: `csrc/spfh_redux.cu` (B5, bin
counts packed in registers and summed by warp reductions, bf16 rounding of
fast mode inside the kernel) and `csrc/spfh.cu` (the ballot kernel kept to
compare), compiled with g++ against the host emulation in
`tests/torch_cuda_emulation` (fibers for lanes; a barrier for the warp add
reduction and the ballot; a per-block buffer for the dynamic shared memory;
`-ffp-contract=off`, so the _rn arithmetic rounds each operation as the
card does). Run at small shapes and held `torch.equal` to the plain version
`spfh_plain` in both modes: the window staging, the centers read from it,
the packed fields at each width (6 bits for K ≤ 63, 8 for K ≤ 255, 16
beyond), the reductions, the neighbor read outside the window, invalid
edges. What only nvcc and the card can say is `chip_smoke.py`'s. Skipped
where there is no g++.

The sources are rewritten in two places only: `extern __shared__` becomes a
pointer to the emulated block's buffer, and each `<<<...>>>` launch a call of
its launcher.

Tolerance: none against the plain version (the same operations in the same
order, each rounded on its own). One case is also held against the JAX
`spfh_pallas(..., interpret=True)` with the bin-flip budget of
tests/test_torch_fpfh.py (XLA rounds the Darboux products its own way):
at most 1e-3 of the edges in another bin, every other center within 1e-5
relative, distances within 1e-6 relative.
"""
import ctypes
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu.ops import fpfh as jfpfh
from se3_equi_graph_registration_tpu.ops import morton as jmorton
from se3_equi_graph_registration_tpu.ops.pallas.spfh_kernel import spfh_pallas
from se3_equi_graph_registration_tpu_torch.ops import fpfh as tfpfh
from se3_equi_graph_registration_tpu_torch.ops import morton
from se3_equi_graph_registration_tpu_torch.ops.kernels import build
from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as tknn
from se3_equi_graph_registration_tpu_torch.ops.kernels import spfh as tspfh

EMULATION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_cuda_emulation")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the SPFH kernels needs g++")
    out = tmp_path_factory.mktemp("spfh_emulated")
    sources = tuple(tspfh.SOURCES.values())
    for name in sources:
        with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
            source, n = re.subn(r"(\w+(?:<\w+>)?)<<<([^,]+), ([^,]+), ([^,]+), .*?>>>\((.*?)\);",
                                r"emulated_launch(\2, \3, \4, [&] { \1(\5); });", f.read(),
                                flags=re.S)
        assert n == 1
        source, n = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                            r"\1* \2 = static_cast<\1*>(emulated_dynamic_shared);", source)
        assert n == 1
        (out / f"{name}.cpp").write_text(source)
    res = subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                          "-pthread", "-I", str(out), "-I", EMULATION, "-o",
                          str(out / "libspfh.so")] + [str(out / f"{s}.cpp") for s in sources],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "libspfh.so"))
    lib.spfh_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.spfh_redux_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                                      + [ctypes.c_void_p])
    return lib


def launch(lib, variant, x, normals, nbr, tile, window, accurate):
    """One launch of the variant's emulated kernel, with the arguments the
    wrapper `spfh.spfh` passes (the ballot kernel takes fast mode's inputs
    rounded to bf16 outside, as the wrapper rounds them)."""
    b, n, k = nbr.shape
    w, pad_tiles, max_tile = tknn._geometry(n, tile, window, False, k)
    out = torch.full((b, n, 33), float("nan"))
    dist = torch.full((b, n, k), float("nan"))
    ints = [b, n, k, tile, w, pad_tiles, max_tile]
    if variant == "redux":
        ints.append(int(accurate))
    elif not accurate:
        x, normals = tspfh.round_bf16(x), tspfh.round_bf16(normals)
    fn = getattr(lib, f"{tspfh.SOURCES[variant]}_launch")
    assert fn(x.data_ptr(), normals.data_ptr(), nbr.data_ptr(), out.data_ptr(), dist.data_ptr(),
              tspfh._SECTOR.ctypes.data, *ints, None) == 0
    return out, dist


def surface(seed, b, n, kind="surface"):
    """Curve-sorted samples [b, n, 3] of a smooth random height field with
    2 mm noise; 'repeated': every point twice (the duplicate and the self
    pair are invalid edges); 'flat': the plane z = 0."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (b, n, 2))
    z = np.zeros((b, n))
    for _ in range(4):
        a, f, g, p = rng.uniform(0.1, 0.3), rng.uniform(1, 4), rng.uniform(1, 4), rng.uniform(0, 6)
        z += a * np.sin(f * xy[..., 0] + p) * np.cos(g * xy[..., 1])
    x = np.concatenate([xy, z[..., None]], -1) + rng.standard_normal((b, n, 3)) * 0.002
    if kind == "repeated":
        x[:, 1::2] = x[:, ::2]
    if kind.startswith("flat"):
        x[..., 2] = 0.0
    _, xs, _ = morton.sort_by_curve(torch.zeros(b, n, 0), torch.from_numpy(x.astype(np.float32)))
    return xs.contiguous()


def inputs(seed, b, n, k, tile, w, kind):
    """(x, normals, nbr) of a case: the exact window k-NN at (tile, w) and
    the window normals; for 'anywhere' neighbor ids drawn from the whole
    cloud (most outside the tile's window, read from device memory by the
    kernels); for 'flat' the plane with every normal +z (every valid edge
    falls in the same α, φ and θ bins: a field's sum reaches the count of
    valid edges); 'flat-anywhere' both, with no self pair (all K valid)."""
    x = surface(seed, b, n, kind)
    nbr = tknn.knn_window_plain(x, k, tile, w, packed=False)
    normals = tfpfh.estimate_normals_window(x, nbr[..., :min(k, 16)]).contiguous()
    if kind.startswith("flat"):
        normals = torch.zeros_like(x)
        normals[..., 2] = 1.0
    if kind.endswith("anywhere"):
        rng = np.random.default_rng(seed + 1)
        ids = rng.integers(1, n, (b, n, k)) + np.arange(n)[None, :, None]
        nbr = torch.from_numpy((ids % n).astype(np.int32))      # never the center itself
    return x, normals, nbr


# (b, n, k, tile, window, kind)
CASES = {
    "K16": (1, 512, 16, 128, 256, "surface"),
    "K32": (1, 512, 32, 128, 256, "surface"),
    "K33": (1, 512, 33, 128, 256, "surface"),
    "K60": (1, 512, 60, 128, 256, "surface"),
    "K63-last-6-bit": (1, 256, 63, 128, 256, "surface"),
    "K100-8-bit-fields": (1, 512, 100, 128, 256, "surface"),
    "K300-16-bit-fields": (1, 384, 300, 128, 384, "surface"),
    "K33-repeated": (1, 512, 33, 128, 256, "repeated"),
    "K60-flat": (1, 256, 60, 128, 256, "flat"),
    "K63-flat-anywhere-6-bit-sums-at-63": (1, 256, 63, 128, 256, "flat-anywhere"),
    "K64-flat-anywhere-8-bit-sums-at-64": (1, 256, 64, 128, 256, "flat-anywhere"),
    "B3-N128-T64-W128-K20": (3, 128, 20, 64, 128, "surface"),
    "B2-K40-anywhere": (2, 256, 40, 64, 128, "anywhere"),
}


@pytest.mark.parametrize("accurate", [True, False], ids=["accurate", "fast"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernels_equal_the_plain_version(lib, case, accurate):
    b, n, k, tile, w, kind = CASES[case]
    x, normals, nbr = inputs(len(case), b, n, k, tile, w, kind)
    ref_s, ref_d = tspfh.spfh_plain(x, normals, nbr, tile, w, accurate)
    for variant in tspfh.VARIANTS:
        got_s, got_d = launch(lib, variant, x, normals, nbr, tile, w, accurate)
        assert torch.equal(got_d, ref_d), variant
        assert torch.equal(got_s, ref_s), variant
    valid = (ref_d > 0).sum(-1)
    assert torch.allclose(ref_s[..., :11].sum(-1)[valid > 0], torch.tensor(100.0), atol=1e-3)
    if kind == "repeated":          # the duplicate and the self pair of every center
        assert bool((valid == k - 2).all())
    if kind == "flat-anywhere":     # every edge valid, each channel's count in one bin
        assert bool((valid == k).all())
        counts = (ref_s * k / 100.0).round().reshape(b, n, 3, 11)
        assert bool((counts.amax(-1) == k).all())


def test_emulated_fast_mode_rounds_inside_the_kernel(lib):
    """Fast mode takes fp32 inputs and rounds them to bf16 in the kernel:
    the same output as accurate mode on inputs rounded beforehand, and not
    the same as accurate mode on the inputs as given."""
    x, normals, nbr = inputs(7, 1, 256, 30, 128, 256, "surface")
    fast = launch(lib, "redux", x, normals, nbr, 128, 256, False)
    pre = launch(lib, "redux", tspfh.round_bf16(x), tspfh.round_bf16(normals), nbr, 128, 256,
                 True)
    acc = launch(lib, "redux", x, normals, nbr, 128, 256, True)
    assert torch.equal(fast[0], pre[0]) and torch.equal(fast[1], pre[1])
    assert not torch.equal(fast[1], acc[1])


def _counts(spfh, dist):
    """Integer bin counts [N, 33] back from SPFH rows scaled to 100 per channel."""
    valid = (dist > 0).sum(-1, keepdims=True)
    return np.rint(spfh * valid / 100.0).astype(np.int64)


def test_emulated_kernel_matches_pallas_interpret(lib):
    """The new kernel against the Pallas kernel on the cloud, window graph
    and normals of tests/test_torch_fpfh.py (a 512-point sample of a smooth
    random surface, k=40, tile 128, window 256, all from the JAX package),
    where the plain version meets the same budget."""
    rng = np.random.default_rng(0)
    gx, gy = np.meshgrid(np.linspace(-1, 1, 24), np.linspace(-1, 1, 24))
    z = np.zeros_like(gx)
    for _ in range(5):
        a = rng.uniform(0.1, 0.3)
        f, g, p = rng.uniform(1, 4), rng.uniform(1, 4), rng.uniform(0, 6)
        z += a * np.sin(f * gx + p) * np.cos(g * gy)
    pts = np.stack([gx, gy, z], -1).reshape(-1, 3).astype(np.float32)
    pts = pts + rng.standard_normal(pts.shape).astype(np.float32) * 0.002
    x = jnp.asarray(pts[np.random.default_rng(3).permutation(len(pts))[:512]])
    _, xs, _ = jmorton.sort_by_curve(jnp.zeros((512, 0)), x)
    nbr = jmorton.knn_graph_window(xs, 40, tile=128, window=256)
    nrm = jfpfh.estimate_normals_window(xs, nbr[:, :20], 128, 256)
    s_ref, d_ref = (np.array(a) for a in spfh_pallas(xs, nrm, nbr, 256, tile_t=128,
                                                    interpret=True, accurate=True))
    got = launch(lib, "redux", torch.from_numpy(np.array(xs))[None],
                 torch.from_numpy(np.array(nrm))[None], torch.from_numpy(np.array(nbr))[None],
                 128, 256, True)
    s_got, d_got = got[0][0].numpy(), got[1][0].numpy()
    np.testing.assert_allclose(d_got, d_ref, rtol=1e-6, atol=0)
    assert np.all((d_got == 0).sum(axis=1) == 1)                   # the self pair only
    dc = np.abs(_counts(s_got, d_got) - _counts(s_ref, d_ref))
    assert dc.sum() / 2 <= 1e-3 * d_got.size, dc.sum() / 2          # edges in another bin
    same = dc.sum(-1) == 0
    np.testing.assert_allclose(s_got[same], s_ref[same], rtol=1e-5, atol=0)

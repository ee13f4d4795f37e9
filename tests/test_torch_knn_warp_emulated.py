"""The warp-a-query k-NN kernels' own sources on the CPU: `csrc/knn_warp.cu`
(B1 packed), `csrc/knn_exact_warp.cu` (B1 exact, over a window or the whole
cloud) and `csrc/knn_chunked_warp.cu` (B4) with `csrc/knn_select.cuh`,
compiled with g++ against the host emulation in `tests/torch_cuda_emulation`
(fibers for lanes; a barrier for the warp min reduction and the ballot; a
per-block buffer for the dynamic shared memory; `-ffp-contract=off`, so the
_rn arithmetic rounds each operation as the card does). Run at small shapes
and held `torch.equal` to the plain versions `knn_window_plain` (packed and
exact) and `knn_chunked_plain`: the staging layouts, the per-lane sorting
networks, the warp-min extraction, the per-warp lists, the exact kernel's
filter, buffer and running list, and the window starts, except what only
nvcc and the card can say (`chip_smoke.py`). Skipped where there is no g++.

The sources are rewritten in two places only: `extern __shared__` becomes a
pointer to the emulated block's buffer, and each `<<<...>>>` launch a call of
its launcher.

Tolerance: none; the lists must be identical (the same keys from the same
round-to-nearest d²: unique within a query in packed mode, ties broken by
the lower id in exact mode). One case of each packed kernel, one exact
window and one whole cloud are also held against the JAX
`knn_pallas(..., interpret=True)`, up to near-ties (d² within 2⁻¹² of the
row's k-th), as tests/test_torch_knn.py and tests/test_torch_knn_chunked.py
hold the plain versions.
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
from torch_port_util import neighbor_set_mismatches

from se3_equi_graph_registration_tpu.ops.pallas.knn_kernel import knn_pallas
from se3_equi_graph_registration_tpu_torch.ops import morton
from se3_equi_graph_registration_tpu_torch.ops.kernels import build
from se3_equi_graph_registration_tpu_torch.ops.kernels import knn as tknn

EMULATION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_cuda_emulation")
SOURCES = ("knn_warp", "knn_exact_warp", "knn_chunked_warp")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the k-NN kernels needs g++")
    out = tmp_path_factory.mktemp("knn_warp_emulated")
    shutil.copy(os.path.join(build.CSRC, "knn_select.cuh"), out)
    for name in SOURCES:
        with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
            source, n = re.subn(r"(\w+(?:<\w+>)?)<<<(\w+), (\w+), (\w+), [^>]*>>>\((.*?)\);",
                                r"emulated_launch(\2, \3, \4, [&] { \1(\5); });", f.read(),
                                flags=re.S)
        assert n == 1
        source, n = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                            r"\1* \2 = static_cast<\1*>(emulated_dynamic_shared);", source)
        assert n == 1
        (out / f"{name}.cpp").write_text(source)
    res = subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                          "-pthread", "-I", str(out), "-I", EMULATION, "-o",
                          str(out / "libknn_warp.so")] + [str(out / f"{s}.cpp") for s in SOURCES],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "libknn_warp.so"))
    lib.knn_warp_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.knn_chunked_warp_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 10
                                            + [ctypes.c_void_p])
    lib.knn_exact_warp_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                                          + [ctypes.c_void_p])
    return lib


def cloud(seed, b, n, kind="uniform", sort=True):
    """Clouds [b, n, 3] f32, curve-sorted unless `sort=False` (the whole-cloud
    paths take clouds as they come): uniform in a 3 m cube; 'repeated'
    (every point twice: keys that tie in their masked bits, and exact d²
    that tie, so the id decides); 'offset' (the cube moved by 1e3: d² of
    near neighbors lost to cancellation, many negative); 'equal' (one point
    n times: every d² is 0); 'class0' (unsorted, every 3rd point near the
    origin: at W=384 B4's shortlist drops true neighbors)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (b, n, 3)).astype(np.float32)
    if kind == "class0":
        x = rng.uniform(0.5, 1.0, (b, n, 3)).astype(np.float32)
        x[:, ::3] = rng.uniform(-0.1, 0.1, (b, len(range(0, n, 3)), 3))
        return torch.from_numpy(x)
    if kind == "repeated":
        x[:, 1::2] = x[:, ::2]
    if kind == "offset":
        x += np.float32(1e3)
    if kind == "equal":
        x[:] = x[:, :1]
    if not sort:
        return torch.from_numpy(x)
    _, xs, _ = morton.sort_by_curve(torch.zeros(b, n, 0), torch.from_numpy(x))
    return xs.contiguous()


def launch_window(lib, x, k, tile, w, include_self=True, qpw=1):
    b, n, _ = x.shape
    _, pad_tiles, max_tile = tknn._geometry(n, tile, w, True, k)
    out = torch.full((b, n, k), -1, dtype=torch.int32)
    assert lib.knn_warp_launch(x.data_ptr(), out.data_ptr(), b, n, k, tile, w, pad_tiles,
                               max_tile, int(include_self), qpw, None) == 0
    return out


def launch_exact(lib, x, k, tile, w, include_self=True, qpw=1):
    b, n, _ = x.shape
    t, w_, pad_tiles, max_tile = tknn.exact_warp_geometry(n, k, tile, w)
    out = torch.full((b, n, k), -1, dtype=torch.int32)
    assert lib.knn_exact_warp_launch(x.data_ptr(), out.data_ptr(), b, n, k, t, w_, pad_tiles,
                                     max_tile, int(include_self), qpw, None) == 0
    return out


def launch_chunked(lib, x, k, tile, w, include_self=True, qpw=1):
    b, n, _ = x.shape
    pad_tiles, max_tile, _, s_pc = tknn._chunked_geometry(n, tile, w, k)
    out = torch.full((b, n, k), -1, dtype=torch.int32)
    assert lib.knn_chunked_warp_launch(x.data_ptr(), out.data_ptr(), b, n, k, tile, w, s_pc,
                                       pad_tiles, max_tile, int(include_self), qpw, None) == 0
    return out


# (b, n, k, tile, window, include_self, cloud kind, queries a warp)
WINDOW_CASES = {
    "W128-K1-B2": (2, 128, 1, 128, 128, True, "uniform", 1),
    "W384-K16-served": (1, 512, 16, 128, 384, True, "uniform", 4),
    "W768-K60": (1, 768, 60, 128, 768, True, "uniform", 4),
    "W1024-K30": (1, 1024, 30, 128, 1024, True, "uniform", 4),
    "W384-K16-no-self": (1, 512, 16, 128, 384, False, "uniform", 4),
    "W384-K16-repeated": (1, 384, 16, 128, 384, True, "repeated", 4),
    "W384-K16-offset-1e3": (1, 384, 16, 128, 384, True, "offset", 1),
    "W128-K128-all": (1, 128, 128, 128, 128, True, "uniform", 1),
    "W320-T64-K16-pads": (1, 384, 16, 64, 320, True, "uniform", 2),
}
# (b, n, k, tile, window (None: the whole cloud), include_self, cloud kind,
# curve-sorted, queries a warp)
EXACT_CASES = {
    "W128-K16-B2": (2, 256, 16, 128, 128, True, "uniform", True, 1),
    "W384-K16-served": (1, 512, 16, 128, 384, True, "uniform", True, 4),
    "W1024-K30": (1, 1024, 30, 128, 1024, True, "uniform", True, 4),
    "W384-K16-no-self": (1, 512, 16, 128, 384, False, "uniform", True, 4),
    "W384-K30-repeated": (1, 384, 30, 128, 384, True, "repeated", True, 4),
    "W384-K16-offset-1e3": (1, 384, 16, 128, 384, True, "offset", True, 1),
    "W384-K128": (1, 384, 128, 128, 384, True, "uniform", True, 1),
    "whole-N1280-K16-two-chunks": (1, 1280, 16, 128, None, True, "uniform", False, 4),
    "whole-N2000-T125-K16": (1, 2000, 16, 125, None, True, "uniform", False, 4),
    "whole-N251-T1-K8-prime": (1, 251, 8, 1, None, True, "uniform", False, 1),
    "whole-N640-K60-no-self": (1, 640, 60, 128, None, False, "uniform", False, 2),
    "whole-N1280-K16-repeated": (1, 1280, 16, 128, None, True, "repeated", False, 4),
    "whole-N1280-K16-equal": (1, 1280, 16, 128, None, True, "equal", False, 4),
    "whole-N640-K90-offset-1e3": (1, 640, 90, 128, None, True, "offset", False, 2),
    "whole-N256-K1-B2": (2, 256, 1, 128, None, True, "uniform", False, 1),
}
CHUNKED_CASES = {
    "W128-K16-B2": (2, 128, 16, 128, 128, True, "uniform", 1),
    "W256-K1": (1, 512, 1, 128, 256, True, "uniform", 4),
    "W384-K30": (1, 512, 30, 128, 384, True, "uniform", 4),
    "W768-K60": (1, 768, 60, 128, 768, True, "uniform", 4),
    "W1024-K30": (1, 1024, 30, 128, 1024, True, "uniform", 4),
    "W384-K16-no-self": (1, 384, 16, 128, 384, False, "uniform", 1),
    "W384-K30-repeated": (1, 384, 30, 128, 384, True, "repeated", 4),
    "W384-K16-offset-1e3": (1, 384, 16, 128, 384, True, "offset", 1),
    "W384-K30-class0": (1, 384, 30, 128, 384, True, "class0", 4),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_emulated_window_kernel_equals_the_plain_packed_version(lib, case):
    b, n, k, tile, w, include_self, kind, qpw = WINDOW_CASES[case]
    x = cloud(len(case), b, n, kind)
    got = launch_window(lib, x, k, tile, w, include_self, qpw)
    ref = tknn.knn_window_plain(x, k, tile, w, packed=True, include_self=include_self)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_emulated_exact_kernel_equals_the_plain_exact_version(lib, case):
    b, n, k, tile, w, include_self, kind, sort, qpw = EXACT_CASES[case]
    x = cloud(len(case), b, n, kind, sort)
    got = launch_exact(lib, x, k, tile, w, include_self, qpw)
    ref = tknn.knn_window_plain(x, k, tile, w, packed=False, include_self=include_self)
    assert torch.equal(got, ref)
    if kind == "equal":      # every d² is 0: the lowest ids win, in order
        assert torch.equal(got[0], torch.arange(k, dtype=torch.int32).expand(n, k))
    if kind == "offset":     # cancellation makes d² negative, and those come first
        q = x[0].double()
        assert bool((((q[:, None] - q[got[0].long()]) ** 2).sum(-1) >= 0).all())


@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_emulated_chunked_kernel_equals_the_plain_version(lib, case):
    b, n, k, tile, w, include_self, kind, qpw = CHUNKED_CASES[case]
    x = cloud(len(case), b, n, kind)
    got = launch_chunked(lib, x, k, tile, w, include_self, qpw)
    ref = tknn.knn_chunked_plain(x, k, tile, w, include_self=include_self)
    assert torch.equal(got, ref)
    if kind == "class0":     # the shortlist keeps S_pc = 20 of class 0's 30 nearest
        assert int((got[0, 0] % 3 == 0).sum()) == 20


def test_emulated_kernels_match_pallas_interpret(lib):
    x = cloud(3, 1, 384)
    xn = x.numpy()
    for chunked, launch in ((False, launch_window), (True, launch_chunked)):
        ref = np.asarray(knn_pallas(jnp.asarray(xn), 16, tile_t=128, window=384, packed=True,
                                    chunked=chunked, interpret=True))
        got = launch(lib, x, 16, 128, 384).numpy()
        assert neighbor_set_mismatches(xn, ref, got) <= 0.01 * 384
        assert np.mean(np.all(ref == got, -1)) >= 0.98   # in order, up to near-ties


@pytest.mark.parametrize("window,sort", [(384, True), (None, False)],
                         ids=["exact-window-384", "exact-whole-cloud"])
def test_emulated_exact_kernel_matches_pallas_interpret(lib, window, sort):
    x = cloud(5, 1, 512, sort=sort)
    xn = x.numpy()
    ref = np.asarray(knn_pallas(jnp.asarray(xn), 16, tile_t=128, window=window, packed=False,
                                interpret=True))
    got = launch_exact(lib, x, 16, 128, window, qpw=4).numpy()
    assert neighbor_set_mismatches(xn, ref, got) <= 0.01 * 512
    assert np.mean(np.all(ref == got, -1)) >= 0.98       # in order, up to near-ties

"""The warp-a-query k-NN kernels' own sources on the CPU: `csrc/knn_warp.cu`
(B1 packed), `csrc/knn_exact_warp.cu` (B1 exact, over a window or the whole
cloud, k ≤ 128), `csrc/knn_exact_large.cu` (B1 exact at 128 < k ≤ 1024) and
`csrc/knn_chunked_warp.cu` (B4) with `csrc/knn_select.cuh`,
compiled with g++ against the host emulation in `tests/torch_cuda_emulation`
(fibers for lanes; a barrier for the warp min reduction and the ballot; a
per-block buffer for the dynamic shared memory; `-ffp-contract=off`, so the
_rn arithmetic rounds each operation as the card does). Run at small shapes
and held `torch.equal` to the plain versions `knn_window_plain` (packed and
exact) and `knn_chunked_plain`: the staging layouts, the per-lane sorting
networks, the warp-min extraction, the per-warp lists, the exact kernel's
filter, buffer and running list, the large-k kernel's radix search, compaction
and bitonic sort, and the window starts, except what only nvcc and the card
can say (`chip_smoke.py`). A mutant of the large-k kernel that takes the tied
keys at the K-th d² by the higher id must fail. Skipped where there is no g++.

The sources are rewritten in two places only: `extern __shared__` becomes a
pointer to the emulated block's buffer, and each `<<<...>>>` launch a call of
its launcher.

Tolerance: none; the lists must be identical (the same keys from the same
round-to-nearest d²: unique within a query in packed mode, ties broken by
the lower id in exact mode). One case of each packed kernel, and one exact
window and one whole cloud of each exact kernel, are also held against the
JAX `knn_pallas(..., interpret=True)`, up to near-ties (d² within 2⁻¹² of
the row's k-th), as tests/test_torch_knn.py and tests/test_torch_knn_chunked.py
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
SOURCES = ("knn_warp", "knn_exact_warp", "knn_exact_large", "knn_chunked_warp")
# the large-k kernel's compaction takes the keys tied at the K-th d² in order
# of id; the mutant counts a tied key's rank from the lanes above it, so
# within 32 candidates the higher ids win
TIE_MUTATION = ("ties + __popc(on_ballot & lanes_below)",
                "ties + __popc(on_ballot & ~lanes_below & ~(1u << lane))")


def emulated_source(name, out, mutation=None):
    """csrc/<name>.cu rewritten for the host emulation into out/<name>.cpp."""
    with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
        source, n = re.subn(r"(\w+(?:<\w+>)?)<<<(\w+), (\w+), (\w+), [^>]*>>>\((.*?)\);",
                            r"emulated_launch(\2, \3, \4, [&] { \1(\5); });", f.read(),
                            flags=re.S)
    assert n == 1
    source, n = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                        r"\1* \2 = static_cast<\1*>(emulated_dynamic_shared);", source)
    assert n == 1
    if mutation:
        assert source.count(mutation[0]) == 1
        source = source.replace(*mutation)
    (out / f"{name}.cpp").write_text(source)
    return str(out / f"{name}.cpp")


def compile_emulated(out, libs):
    """{library file: (sources, mutation)} → {library file: CDLL}, every
    source compiled at once, one g++ each, into out."""
    shutil.copy(os.path.join(build.CSRC, "knn_select.cuh"), out)
    flags = ["-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-pthread", "-I", str(out),
             "-I", EMULATION]
    jobs = {}
    for lib_name, (names, mutation) in libs.items():
        sub = out / lib_name.replace(".", "_")
        sub.mkdir()
        for name in names:
            cpp = emulated_source(name, sub, mutation)
            jobs[lib_name, name] = subprocess.Popen(
                ["g++", *flags, "-c", "-o", cpp[:-4] + ".o", cpp], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    for job in jobs.values():
        log, _ = job.communicate(timeout=300)
        assert job.returncode == 0, log
    loaded = {}
    for lib_name, (names, _) in libs.items():
        sub = out / lib_name.replace(".", "_")
        res = subprocess.run(["g++", "-shared", "-o", str(out / lib_name)]
                             + [str(sub / f"{name}.o") for name in names],
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        lib = loaded[lib_name] = ctypes.CDLL(str(out / lib_name))
        for name in names:
            ints = 10 if name == "knn_chunked_warp" else 9
            getattr(lib, f"{name}_launch").argtypes = ([ctypes.c_void_p] * 2
                                                       + [ctypes.c_int] * ints
                                                       + [ctypes.c_void_p])
    return loaded


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the k-NN kernels needs g++")
    return compile_emulated(tmp_path_factory.mktemp("knn_warp_emulated"),
                            {"libknn_warp.so": (SOURCES, None),
                             "libknn_mutant.so": (("knn_exact_large",), TIE_MUTATION)})


@pytest.fixture(scope="module")
def lib(libs):
    return libs["libknn_warp.so"]


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


def launch_exact(lib, x, k, tile, w, include_self=True, qpw=1, source="knn_exact_warp"):
    b, n, _ = x.shape
    t, w_, pad_tiles, max_tile = tknn.exact_warp_geometry(n, k, tile, w)
    out = torch.full((b, n, k), -1, dtype=torch.int32)
    assert getattr(lib, f"{source}_launch")(x.data_ptr(), out.data_ptr(), b, n, k, t, w_,
                                            pad_tiles, max_tile, int(include_self), qpw,
                                            None) == 0
    return out


def launch_large(lib, x, k, tile, w, include_self=True, qpw=1):
    return launch_exact(lib, x, k, tile, w, include_self, qpw, source="knn_exact_large")


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
# exact keys at 128 < k ≤ 1024 (csrc/knn_exact_large.cu): 8, 16 and 32 keys a
# lane, k = W, one chunk and two; same fields as EXACT_CASES
LARGE_CASES = {
    "W256-K129-B2": (2, 512, 129, 128, 256, True, "uniform", True, 1),
    "W384-K200": (1, 512, 200, 128, 384, True, "uniform", True, 4),
    "W384-K300-no-self": (1, 512, 300, 128, 384, False, "uniform", True, 2),
    "W384-K300-repeated": (1, 384, 300, 128, 384, True, "repeated", True, 4),
    "W256-K256-all": (1, 256, 256, 128, 256, True, "uniform", True, 1),
    "whole-N384-K300": (1, 384, 300, 128, None, True, "uniform", False, 4),
    "whole-N512-K129-no-self-B2": (2, 512, 129, 128, None, False, "uniform", False, 1),
    "whole-N256-K200-equal": (1, 256, 200, 128, None, True, "equal", False, 4),
    "whole-N640-K300-offset-1e3": (1, 640, 300, 128, None, True, "offset", False, 2),
    "whole-N640-K600-repeated": (1, 640, 600, 128, None, True, "repeated", False, 4),
    "whole-N1280-K200-two-chunks": (1, 1280, 200, 128, None, True, "uniform", False, 4),
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


@pytest.mark.parametrize("case", list(LARGE_CASES))
def test_emulated_large_k_kernel_equals_the_plain_exact_version(lib, case):
    b, n, k, tile, w, include_self, kind, sort, qpw = LARGE_CASES[case]
    x = cloud(len(case), b, n, kind, sort)
    got = launch_large(lib, x, k, tile, w, include_self, qpw)
    ref = tknn.knn_window_plain(x, k, tile, w, packed=False, include_self=include_self)
    assert torch.equal(got, ref)
    if kind == "equal":      # every d² is 0: the lowest ids win, in order
        assert torch.equal(got[0], torch.arange(k, dtype=torch.int32).expand(n, k))
    if kind == "offset":     # cancellation makes d² negative, and those come first
        q = x[0].double()
        assert bool((((q[:, None] - q[got[0].long()]) ** 2).sum(-1) >= 0).all())
    if w is not None and w < n:   # the window keeps out nearer points of the cloud
        whole = tknn.knn_window_plain(x, k, tile, None, packed=False, include_self=include_self)
        assert not torch.equal(got, whole)


@pytest.mark.parametrize("n,window,sort", [(384, 256, True), (256, None, False)],
                         ids=["large-k-window-256", "large-k-whole-cloud"])
def test_emulated_large_k_kernel_matches_pallas_interpret(lib, n, window, sort):
    x = cloud(7, 1, n, sort=sort)
    xn = x.numpy()
    ref = np.asarray(knn_pallas(jnp.asarray(xn), 129, tile_t=128, window=window, packed=False,
                                interpret=True))
    got = launch_large(lib, x, 129, 128, window, qpw=4).numpy()
    assert neighbor_set_mismatches(xn, ref, got) <= 0.01 * n
    assert np.mean(np.all(ref == got, -1)) >= 0.98       # in order, up to near-ties


def test_emulated_large_k_kernel_without_the_id_tie_break_fails(libs):
    """At an odd k the K-th d² splits a pair of repeated points: the kernel
    takes the lower id, the mutant the higher."""
    x = cloud(11, 1, 384, "repeated")
    ref = tknn.knn_window_plain(x, 301, 128, 384, packed=False)
    assert torch.equal(launch_large(libs["libknn_warp.so"], x, 301, 128, 384, qpw=4), ref)
    got = launch_large(libs["libknn_mutant.so"], x, 301, 128, 384, qpw=4)
    assert not torch.equal(got, ref)
    assert torch.equal(got[..., :300], ref[..., :300])   # only the tie at the K-th differs

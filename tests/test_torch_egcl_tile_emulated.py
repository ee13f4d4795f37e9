"""The tile kernel's own source on the CPU: `csrc/egcl_tile.cu` and
`csrc/egcl_tile.cuh` compiled with g++ against the host emulation in
`tests/torch_cuda_emulation` (threads for lanes, barriers for shuffles and
`mma.sync`), run at small shapes and held against the plain version. Both
compiled widths run from one library: CP=32 at C=32, and CP=48 at KITTI's
C=33 (one head, and three heads of 11) with zero pads in the channels
33..47. This reaches what the card check reaches — staging (at C=33 from
rows of the true stride), masks, fragment chaining, LayerNorm and sums on
fragments with the pads masked out, the packed buffer — except what only
nvcc and the card can say (that it builds, launches and how fast it runs;
`chip_smoke.py`). Skipped where there is no g++. A mutant built without
the LayerNorm variance's pad mask fails the C=33 forward.

The source is rewritten in three places only: the `mma.sync` PTX statement
becomes a call of the emulation's mma, `extern __shared__` a pointer to the
emulated block's buffer, and each `<<<...>>>` launch a call of its launcher.

Tolerances: the card check's fast tolerances (2e-2 of the scale on h′, agg_m
and the per-edge stages, 1e-2 on the update u = x′ − x); measured here ≤ 3e-4
at C=32, since only the order of fp32 sums differs.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
from se3_equi_graph_registration_tpu_torch.ops.kernels import build
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl as tk
from se3_equi_graph_registration_tpu_torch.ops.knn import knn_graph

EMULATION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_cuda_emulation")


# the pad mask of the LayerNorm variance (egcl_tile.cuh::normalize): without
# it the pads' (0 - mean)² enter the variance at C=33
VARIANCE_MASK = "const bool r0 = real<CP>(n, t, 0, c), r1 = real<CP>(n, t, 1, c);"


def _build(out, header_edit=None):
    """csrc/egcl_tile.{cu,cuh} rewritten for the emulation and compiled into
    `out`; `header_edit` (old, new) mutates the header first."""
    with open(os.path.join(build.CSRC, "egcl_tile.cuh")) as f:
        header, n = re.subn(r'asm\("mma\.sync.*?\)\);', "emulated_mma(d, a, b);", f.read(),
                            flags=re.S)
    assert n == 1
    if header_edit is not None:
        assert header.count(header_edit[0]) == 1
        header = header.replace(*header_edit)
    with open(os.path.join(build.CSRC, "egcl_tile.cu")) as f:
        source, n = re.subn(r"(\w+(?:<\w+>)?)<<<(\w+), ([\w *]+), (\w+), [^>]*>>>\((.*?)\);",
                            r"emulated_launch(\2, \3, \4, [&] { \1(\5); });", f.read(), flags=re.S)
    assert n == 2
    source, n = re.subn(r"extern __shared__ __align__\(16\) uint32_t smem\[\];",
                        "uint32_t* smem = static_cast<uint32_t*>(emulated_dynamic_shared);", source)
    assert n == 1
    (out / "egcl_tile.cuh").write_text(header)
    (out / "egcl_tile.cpp").write_text(source)
    res = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                          "-I", str(out), "-I", EMULATION, "-I", build.CSRC, "-o", str(out / "libegcl_tile.so"),
                          str(out / "egcl_tile.cpp")], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "libegcl_tile.so"))
    lib.egcl_tile_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.egcl_tile_mma_probe.argtypes = [ctypes.c_void_p] * 4
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """One library: both compiled widths (the kernel is a template on CP)."""
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the tile kernel needs g++")
    return _build(tmp_path_factory.mktemp("egcl_tile_emulated"))


def test_emulated_mma_tile_matches_a_matrix_product(lib):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    block = tk.b_fragments(w)[:128].contiguous().view(torch.float32)
    d = torch.empty(16, 8)
    assert lib.egcl_tile_mma_probe(a.data_ptr(), block.data_ptr(), d.data_ptr(), None) == 0
    ref = a.float() @ w[:8].to(torch.bfloat16).float().T
    assert (d - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("b,n,k,heads,repeat", [
    (1, 64, 16, 4, False), (2, 40, 12, 1, False), (1, 48, 20, 4, False),
    (1, 64, 16, 4, True), (1, 32, 3, 32, False),
], ids=["K16-4heads", "K12-1head-B2", "K20-two-row-tiles", "repeated-points", "K3-32heads"])
def test_emulated_tile_kernel_matches_the_plain_fast_layer(lib, b, n, k, heads, repeat):
    rng = np.random.default_rng(k)
    egnn = EGNN(in_node_nf=32, hidden_nf=32, out_node_nf=32, n_layers=1, num_heads=heads)
    with torch.no_grad():
        for q in egnn.parameters():          # O(1/√fan-in) everywhere, the coord output too
            scale = 0.1 if q.ndim == 1 else 1.0 / np.sqrt(q.shape[-1])
            q.copy_(torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(np.float32)) * scale)
        egnn.gcl_0.layer_norm.weight.add_(1.0)
    p = tk.params_from_layer(egnn.gcl_0)
    h = torch.from_numpy(rng.standard_normal((b, n, 32)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (b, n, 3)).astype(np.float32))
    if repeat:
        x[:, 1::2] = x[:, ::2]               # coincident points: degenerate frames
    nbr = knn_graph(x, min(k, 16)).to(torch.int32)
    if k > 16:
        nbr = torch.cat([nbr, nbr.flip(1)[..., :k - 16]], dim=-1)
    nbr = nbr.contiguous()
    tile = tk.pack_params_tile(p)
    h_out, x_out, agg_m = torch.empty_like(h), torch.empty_like(x), torch.empty_like(h)
    dbg = torch.zeros(b, n, k, 64)
    assert lib.egcl_tile_launch(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), tile.data_ptr(),
                                h_out.data_ptr(), x_out.data_ptr(), agg_m.data_ptr(),
                                dbg.data_ptr(), b, n, k, 32, p.head_width, None) == 0
    rh, rx, rm = tk.egcl_layer_plain(h, x, nbr, p, accurate=False, return_aggm=True)
    _, s1, m, _ = tk.edge_stages_plain(h, x, nbr, p, accurate=False)
    rel = lambda got, ref: float((got - ref).abs().max() / ref.abs().max())
    assert all(bool(torch.isfinite(t).all()) for t in (h_out, x_out, agg_m))
    assert (rx - x).abs().max() > 1e-3
    assert rel(dbg[..., :32], s1) <= 2e-2 and rel(dbg[..., 32:], m) <= 2e-2
    assert rel(h_out, rh) <= 2e-2 and rel(agg_m, rm) <= 2e-2
    assert rel(x_out - x, rx - x) <= 1e-2
    # without agg_m and the stages the kernel writes the same h′ and x′
    h2, x2 = torch.empty_like(h), torch.empty_like(x)
    assert lib.egcl_tile_launch(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), tile.data_ptr(),
                                h2.data_ptr(), x2.data_ptr(), None, None, b, n, k, 32,
                                p.head_width, None) == 0
    assert torch.equal(h2, h_out) and torch.equal(x2, x_out)


def _c33_layer(heads: int, seed: int) -> tk.EGCLParams:
    """A C=33 layer at O(1/√fan-in) everywhere, the coord output too."""
    rng = np.random.default_rng(seed)
    egnn = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=heads)
    with torch.no_grad():
        for q in egnn.parameters():
            scale = 0.1 if q.ndim == 1 else 1.0 / np.sqrt(q.shape[-1])
            q.copy_(torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(np.float32)) * scale)
        egnn.gcl_0.layer_norm.weight.add_(1.0)
    return tk.params_from_layer(egnn.gcl_0)


def _c33_case(lib, n, k, heads, seed):
    """The emulated C=33 layer (CP=48) with agg_m and the stages, then
    without either → (relative errors against the plain fast version,
    whether the second launch wrote the same h′ and x′)."""
    rng = np.random.default_rng(seed)
    p = _c33_layer(heads, seed)
    h = torch.from_numpy(rng.standard_normal((1, n, 33)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, n, 3)).astype(np.float32))
    nbr = knn_graph(x, k).to(torch.int32).contiguous()
    tile = tk.pack_params_tile(p)
    assert tk.tile_width(33) == 48 and tile.numel() == 8832      # Layout<48>::total
    h_out, x_out, agg_m = torch.empty_like(h), torch.empty_like(x), torch.empty_like(h)
    dbg = torch.zeros(1, n, k, 96)
    assert lib.egcl_tile_launch(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), tile.data_ptr(),
                                h_out.data_ptr(), x_out.data_ptr(), agg_m.data_ptr(),
                                dbg.data_ptr(), 1, n, k, 33, p.head_width, None) == 0
    rh, rx, rm = tk.egcl_layer_plain(h, x, nbr, p, accurate=False, return_aggm=True)
    _, s1, m, _ = tk.edge_stages_plain(h, x, nbr, p, accurate=False)
    rel = lambda got, ref: float((got - ref).abs().max() / ref.abs().max())
    assert (rx - x).abs().max() > 1e-3
    finite = all(bool(torch.isfinite(t).all()) for t in (h_out, x_out, agg_m))
    errs = dict(s1=rel(dbg[..., :33], s1), m=rel(dbg[..., 48:81], m), h=rel(h_out, rh),
                agg_m=rel(agg_m, rm), u=rel(x_out - x, rx - x)) if finite else None
    pads_unwritten = (torch.count_nonzero(dbg[..., 33:48]) == 0
                      and torch.count_nonzero(dbg[..., 81:]) == 0)
    h2, x2 = torch.empty_like(h), torch.empty_like(x)
    assert lib.egcl_tile_launch(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), tile.data_ptr(),
                                h2.data_ptr(), x2.data_ptr(), None, None, 1, n, k, 33,
                                p.head_width, None) == 0
    return errs, pads_unwritten, torch.equal(h2, h_out) and torch.equal(x2, x_out)


@pytest.mark.parametrize("n,k,heads", [(96, 8, 1), (64, 5, 3), (128, 8, 3)],
                         ids=["C33-1head-K8", "C33-3heads-K5", "C33-3heads-N128"])
def test_emulated_tile_kernel_at_c33_matches_the_plain_fast_layer(lib, n, k, heads):
    """KITTI's width on the padded build (CP=48): the stages s1 and m, h′,
    agg_m and the update at the fast tolerances; the stages' pad channels
    stay 0 (the kernel writes them: they are what the products made), and
    the launch without agg_m writes the same h′ and x′."""
    errs, pads_zero, same = _c33_case(lib, n, k, heads, seed=33 + heads)
    assert errs is not None, "non-finite output"
    assert errs["s1"] <= 2e-2 and errs["m"] <= 2e-2, errs
    assert errs["h"] <= 2e-2 and errs["agg_m"] <= 2e-2 and errs["u"] <= 1e-2, errs
    assert pads_zero and same


def test_a_tile_kernel_without_the_variance_pad_mask_fails_at_c33(tmp_path):
    """The mutation check of the pad mask: the same source with the
    LayerNorm variance's mask removed, so that the 15 pads' (0 - mean)²
    enter each row's variance, misses the plain fast layer at C=33."""
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the tile kernel needs g++")
    mutant = _build(tmp_path, (VARIANCE_MASK, "const bool r0 = true, r1 = true;"))
    errs, _, _ = _c33_case(mutant, 96, 8, 1, seed=34)
    assert errs is None or max(errs["m"], errs["h"], errs["agg_m"]) > 2e-2, errs

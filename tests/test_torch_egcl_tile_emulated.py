"""The tile kernel's own source on the CPU: `csrc/egcl_tile.cu` and
`csrc/egcl_tile.cuh` compiled with g++ against the host emulation in
`tests/torch_cuda_emulation` (threads for lanes, barriers for shuffles and
`mma.sync`), run at small shapes and held against the plain version. This
reaches what the card check reaches — staging, masks, fragment chaining,
LayerNorm and sums on fragments, the packed buffer — except what only nvcc
and the card can say (that it builds, launches and how fast it runs;
`chip_smoke.py`). Skipped where there is no g++.

The source is rewritten in two places only: the `mma.sync` PTX statement
becomes a call of the emulation's mma, and each `<<<...>>>` launch a call of
its launcher.

Tolerances: the card check's fast tolerances (2e-2 of the scale on h′, agg_m
and the per-edge stages, 1e-2 on the update u = x′ − x); measured here ≤ 3e-4,
since only the order of fp32 sums differs.
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
GLOBALS = ("\nthread_local dim3m threadIdx, blockIdx, blockDim, gridDim;\n"
           "thread_local WarpCtx* warp_ctx;\nthread_local std::barrier<>* block_bar;\n")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the tile kernel needs g++")
    out = tmp_path_factory.mktemp("egcl_tile_emulated")
    with open(os.path.join(build.CSRC, "egcl_tile.cuh")) as f:
        header, n = re.subn(r'asm\("mma\.sync.*?\)\);', "emulated_mma(d, a, b);", f.read(),
                            flags=re.S)
    assert n == 1
    with open(os.path.join(build.CSRC, "egcl_tile.cu")) as f:
        source, n = re.subn(r"(\w+(?:<\w+>)?)<<<(\w+), ([\w *]+), 0, [^>]*>>>\((.*?)\);",
                            r"emulated_launch(\2, \3, [&] { \1(\4); });", f.read(), flags=re.S)
    assert n == 2
    (out / "egcl_tile.cuh").write_text(header)
    (out / "egcl_tile.cpp").write_text(source + GLOBALS)
    res = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                          "-I", str(out), "-I", EMULATION, "-o", str(out / "libegcl_tile.so"),
                          str(out / "egcl_tile.cpp")], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "libegcl_tile.so"))
    lib.egcl_tile_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.egcl_tile_mma_probe.argtypes = [ctypes.c_void_p] * 4
    return lib


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
                                dbg.data_ptr(), b, n, k, p.head_width, None) == 0
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
                                h2.data_ptr(), x2.data_ptr(), None, None, b, n, k,
                                p.head_width, None) == 0
    assert torch.equal(h2, h_out) and torch.equal(x2, x_out)

"""The backward tile kernel's own source on the CPU:
`csrc/egcl_backward_tile.cu` and `csrc/egcl_tile.cuh` compiled with g++
against the host emulation in `tests/torch_cuda_emulation` (threads for
lanes; barriers for shuffles and `mma.sync`; `std::atomic_ref` for
atomicAdd; a per-block buffer for the dynamic shared memory), run at small
shapes and held against `egcl_backward_plain(accurate=False)`. This reaches
the recomputed forward, the backward's fragment chain, the transposed
operand tiles of the parameter gradients, the geometry backward, the
scatters and the flush, except what only nvcc and the card can say
(`chip_smoke.py`). Skipped where there is no g++.

The source is rewritten in three places only: the `mma.sync` PTX statement
becomes a call of the emulation's mma, `extern __shared__` a pointer to the
emulated block's buffer, and each `<<<...>>>` launch a call of its launcher.

Tolerance: the card check's 5e-3 of each tensor's max-abs scale, on dh, dx,
the 11 parameter gradients and the per-edge stages dcm_in, dv and du.
Measured here ≤ 8.3e-4 over every case (du; only the order of fp32 sums
differs, and with it which side of a bf16 rounding boundary an operand
lands on).
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
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
from se3_equi_graph_registration_tpu_torch.ops.knn import knn_graph

EMULATION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_cuda_emulation")
TOL = 5e-3


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the tile kernels needs g++")
    out = tmp_path_factory.mktemp("egcl_backward_tile_emulated")
    with open(os.path.join(build.CSRC, "egcl_tile.cuh")) as f:
        header, n = re.subn(r'asm\("mma\.sync.*?\)\);', "emulated_mma(d, a, b);", f.read(),
                            flags=re.S)
    assert n == 1
    with open(os.path.join(build.CSRC, "egcl_backward_tile.cu")) as f:
        source, n = re.subn(r"(\w+(?:<\w+>)?)<<<(\w+), ([\w *]+), (\w+), [^>]*>>>\((.*?)\);",
                            r"emulated_launch(\2, \3, \4, [&] { \1(\5); });", f.read(), flags=re.S)
    assert n == 2
    source, n = re.subn(r"extern __shared__ __align__\(16\) uint32_t smem\[\];",
                        "uint32_t* smem = static_cast<uint32_t*>(emulated_dynamic_shared);", source)
    assert n == 1
    (out / "egcl_tile.cuh").write_text(header)
    (out / "egcl_backward_tile.cpp").write_text(source)
    res = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                          "-I", str(out), "-I", EMULATION, "-I", build.CSRC, "-o", str(out / "libbwd.so"),
                          str(out / "egcl_backward_tile.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "libbwd.so"))
    lib.egcl_backward_tile_launch.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                                              + [ctypes.c_void_p])
    lib.egcl_backward_tile_probe.argtypes = [ctypes.c_void_p] * 4
    return lib


def test_emulated_transposed_operand_tile_matches_a_matrix_product(lib):
    rng = np.random.default_rng(1)
    d = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)).to(torch.bfloat16)
    a = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)).to(torch.bfloat16)
    out = torch.empty(32, 32)
    assert lib.egcl_backward_tile_probe(d.data_ptr(), a.data_ptr(), out.data_ptr(), None) == 0
    ref = d.double().T @ a.double()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def _layer(heads: int, seed: int) -> tk.EGCLParams:
    """O(1/√fan-in) weights everywhere, the coord output too, so that the
    coordinate MLP's backward carries weight."""
    rng = np.random.default_rng(seed)
    egnn = EGNN(in_node_nf=32, hidden_nf=32, out_node_nf=32, n_layers=1, num_heads=heads)
    with torch.no_grad():
        for q in egnn.parameters():
            scale = 0.1 if q.ndim == 1 else 1.0 / np.sqrt(q.shape[-1])
            q.copy_(torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(np.float32)) * scale)
        egnn.gcl_0.layer_norm.weight.add_(1.0)
    return tk.params_from_layer(egnn.gcl_0)


def _run(lib, h, x, nbr, p, dagg_m, dagg_x):
    """The emulated kernel → (dh, dx, grads, (dcm_in, dv, du))."""
    b, n, k = nbr.shape
    dh, dx = torch.empty_like(h), torch.empty_like(x)
    dh_nbr, dx_nbr = torch.zeros_like(h), torch.zeros_like(x)
    grads = torch.zeros(5 * 32 * 32 + 18 * 32)
    dbg = torch.zeros(b, n, k, 96)
    tile, tile_bwd = tk.pack_params_tile(p), tk.pack_params_tile_bwd(p)
    assert lib.egcl_backward_tile_launch(
        h.data_ptr(), x.data_ptr(), nbr.data_ptr(), tile.data_ptr(), tile_bwd.data_ptr(),
        dagg_m.data_ptr(), dagg_x.data_ptr(), dh.data_ptr(), dx.data_ptr(), dh_nbr.data_ptr(),
        dx_nbr.data_ptr(), grads.data_ptr(), dbg.data_ptr(), b, n, k, p.head_width, None) == 0
    return (dh + dh_nbr, dx + dx_nbr, eb._unpack_grads(grads, 32),
            (dbg[..., :32], dbg[..., 32:64], dbg[..., 64:]))


@pytest.mark.parametrize("b,n,k,heads,repeat,coord_only", [
    (1, 64, 16, 4, False, False), (2, 40, 12, 1, False, False), (1, 48, 20, 4, False, False),
    (1, 64, 16, 4, True, False), (1, 32, 3, 1, False, False), (1, 64, 16, 4, False, True),
], ids=["K16-4heads", "K12-1head-B2", "K20-two-row-tiles", "repeated-points",
        "K3-32wide-heads", "coordinate-path"])
def test_emulated_backward_tile_kernel_matches_the_plain_fast_backward(
        lib, b, n, k, heads, repeat, coord_only):
    rng = np.random.default_rng(100 + k)
    p = _layer(heads, seed=k)
    h = torch.from_numpy(rng.standard_normal((b, n, 32)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (b, n, 3)).astype(np.float32))
    if repeat:
        x[:, 1::2] = x[:, ::2]               # coincident points: degenerate frames
    nbr = knn_graph(x, min(k, 16)).to(torch.int32)
    if k > 16:
        nbr = torch.cat([nbr, nbr.flip(1)[..., :k - 16]], dim=-1)
    nbr = nbr.contiguous()
    dagg_m = torch.from_numpy(rng.standard_normal((b, n, 32)).astype(np.float32))
    if coord_only:                           # every cotangent through dm = dcm_in · Wc0
        dagg_m.zero_()
    dagg_x = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32))
    dh, dx, grads, stages = _run(lib, h, x, nbr, p, dagg_m, dagg_x)
    rh, rx, rg = eb.egcl_backward_plain(h, x, nbr, p, dagg_m, dagg_x, accurate=False)
    rs = eb.backward_stages_plain(h, x, nbr, p, dagg_m, dagg_x, accurate=False)
    pairs = dict(dh=(dh, rh), dx=(dx, rx), **{q: (grads[q], rg[q]) for q in rg},
                 **{q: (g_, r_) for q, g_, r_ in zip(("dcm_in", "dv", "du"), stages, rs)})
    errs = {}
    for name, (got, ref) in pairs.items():
        assert bool(torch.isfinite(got).all()), name
        scale = float(ref.abs().max())
        assert scale > 0, name
        errs[name] = float((got - ref).abs().max()) / scale
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs)

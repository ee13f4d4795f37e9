#!/usr/bin/env python3
"""Where the accurate-mode EGCL backward kernel spends its time, on one
NVIDIA GPU.

    python3 egcl_f32_sweep.py [--c 33]

Builds timing-only variants of `csrc/egcl_backward_tile_f32.cu` (each one
edit of its source text, compiled beside the package's own build) and
times each against the unedited kernel on the same inputs, in turns, at
B=64, N=2048, K=16, C=32 with 4 heads (or C=33 with one head, on the
kernel built at 36 channels): at most 8 and 12 warps a block; no
parameter-gradient tile products; their shared atomics as plain
read-modify-writes; W2's gradient as the dense product; the gradient
copies at a row stride of 37 at the padded width (2-way bank conflicts in
the atomics, one more warp). Variants that drop or race work give wrong gradients: only
their times mean anything. Prints one JSON line of {variant: ms} with the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

VARIANTS = {
    "8 warps": [("static constexpr int kWarps = fit < 16 ? fit : 16;",
                 "static constexpr int kWarps = fit < 8 ? fit : 8;")],
    "12 warps": [("static constexpr int kWarps = fit < 16 ? fit : 16;",
                  "static constexpr int kWarps = fit < 12 ? fit : 12;")],
    "no gradient products": [
        ("grad_product<CP, kXS, NQ>(gWc0, M, 0, Dt, rg, cg);", ""),
        ("grad_heads8(gW2, S1, Dt, lane);", ";"),
        ("grad_product<CP, kXS, NQ>(gW2, S1, 0, Dt, rg, cg);", ";"),
        ("grad_product<CP, kTS, NQ>(gW1, T, 0, Dt, rg, cg);", ""),
        ("grad_product<CP, kTS, 3>(gW1, T, D::kGeo, Dt, rg, cg);", "")],
    "gradient products without atomics": [
        ("atomicAdd(G + (in0 + a) * kGS + cg + 8 * j, acc[a][j]);",
         "G[(in0 + a) * kGS + cg + 8 * j] += acc[a][j];"),
        ("atomicAdd(G + lane * kG2 + a, acc[a]);", "G[lane * kG2 + a] += acc[a];")],
    "dense W2 gradient": [("grad_heads8(gW2, S1, Dt, lane);",
                           "grad_product<CP, kXS, NQ>(gW2, S1, 0, Dt, rg, cg);")],
    "gradient stride 37 at the padded width": [
        ("static constexpr int kGS = grad_stride(CP, CP + 1);",
         "static constexpr int kGS = CP + 1;"),
        ("static_assert(kGS == (CP == 32 ? 33 : 40)", "static_assert(kGS == CP + 1")],
}
SOURCE = "egcl_backward_tile_f32"


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--c", type=int, choices=(32, 33), default=32,
                    help="the layer width: 32 with 4 heads, or 33 with one head")
    c = ap.parse_args(argv).c
    heads = 4 if c == 32 else 1

    if not torch.cuda.is_available():
        print("egcl_f32_sweep: no CUDA device")
        return 2
    import chip_smoke
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build, egcl, knn
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    dev = torch.device("cuda", 0)
    build.build_all([SOURCE, "knn_exact_warp"])
    with open(os.path.join(build.CSRC, f"{SOURCE}.cu")) as f:
        text = f.read()
    libs = {"default": None}
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in VARIANTS.items():
            src = text
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
                src = src.replace(old, new)
            path = os.path.join(tmp, f"v{len(libs)}.cu")
            with open(path, "w") as f:
                f.write(src)
            subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
                            path[:-3] + ".so", path], check=True, capture_output=True)
            libs[name] = ctypes.CDLL(path[:-3] + ".so")

        gen = torch.Generator().manual_seed(0)
        p = egcl.params_from_layer(EGNN(in_node_nf=c, hidden_nf=c, out_node_nf=c,
                                        n_layers=1, num_heads=heads).to(dev).gcl_0)
        b, n, k = 64, 2048, 16
        x = (torch.rand(b, n, 3, generator=gen) * 3 - 1.5).to(dev)
        h = torch.randn(b, n, c, generator=gen).to(dev)
        nbr = knn.knn_window(x, k, tile=128, window=None, packed=False)
        dm = torch.randn(b, n, c, generator=gen).to(dev)
        dx = torch.randn(b, n, 3, generator=gen).to(dev)
        packed = egcl.pack_for_kernels(p)
        load = build.load
        times = {name: [] for name in libs}
        try:
            for _ in range(2):
                for name, lib in libs.items():
                    build.load = load if lib is None else (
                        lambda nm, lib=lib: lib if nm == SOURCE else load(nm))
                    times[name].append(chip_smoke.cuda_ms(torch, lambda: eb.egcl_backward(
                        h, x, nbr, p, dm, dx, True, packed, "tile_f32"), 5))
        finally:
            build.load = load
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"egcl_backward_tile_f32_ms": {k: min(v) for k, v in times.items()},
                      "C": c, "heads": heads, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the fast-mode EGCL tile kernels spend their time at KITTI's width,
on one NVIDIA GPU.

    python3 egcl_tile_sweep.py [--c 32]

Builds timing-only variants of `csrc/egcl_tile.cu` (B2) and
`csrc/egcl_backward_tile.cu` (B3) (each one edit of a source's text,
compiled beside the package's own build) and times each against the
unedited kernel on the same inputs, in turns, at B=64, N=2048, K=16, C=33
with one head on the kernels built at 48 channels (or C=32 with 4 heads):
B2 at 2 blocks an SM; B3 at 8 warps a block, without its
parameter-gradient tile products, and with their shared atomics (each a
compare-and-swap loop, ATOMS.CAST.SPIN, on sm_90a) as plain
read-modify-writes. Variants that drop or race work give wrong gradients:
only their times mean anything. Prints each variant's ptxas registers and
spills, then one JSON line of {kernel: {variant: ms}} with the card's name
and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

VARIANTS = {
    "egcl_tile": {
        "2 blocks an SM": [("static constexpr int kBlocksPerSM = 3;",
                            "static constexpr int kBlocksPerSM = CP == 32 ? 3 : 2;")],
    },
    "egcl_backward_tile": {
        "8 warps": [("static constexpr int kWarps = fit < 16 ? fit : 16;",
                     "static constexpr int kWarps = fit < 8 ? fit : 8;")],
        "no gradient products": [
            ("grad_product<CP, NT>(gWc0, ad, M, kXS, 0, false, lane);", ""),
            ("grad_product<CP, NT>(gW2, ad, S1, kXS, 0, CP == 32 && wh <= 16, lane);", ""),
            ("grad_product<CP, NT>(gW1hc, ad, tile, kStride, 0, false, lane);", ""),
            ("grad_product<CP, 2>(gW1g, ad, tile, kStride, CP, false, lane);", ""),
            ("add_grad<CP>(gW1hr, dd, mt, 8 * nt, lane);", "")],
        "gradient products without atomics": [
            ("atomicAdd(G + i * kGS + o, d[0]);", "G[i * kGS + o] += d[0];"),
            ("atomicAdd(G + (i + 1) * kGS + o, d[1]);", "G[(i + 1) * kGS + o] += d[1];"),
            ("atomicAdd(G + i * kGS + o + 8, d[2]);", "G[i * kGS + o + 8] += d[2];"),
            ("atomicAdd(G + (i + 1) * kGS + o + 8, d[3]);", "G[(i + 1) * kGS + o + 8] += d[3];")],
        "8 warps, no gradient products": [
            ("static constexpr int kWarps = fit < 16 ? fit : 16;",
             "static constexpr int kWarps = fit < 8 ? fit : 8;"),
            ("grad_product<CP, NT>(gWc0, ad, M, kXS, 0, false, lane);", ""),
            ("grad_product<CP, NT>(gW2, ad, S1, kXS, 0, CP == 32 && wh <= 16, lane);", ""),
            ("grad_product<CP, NT>(gW1hc, ad, tile, kStride, 0, false, lane);", ""),
            ("grad_product<CP, 2>(gW1g, ad, tile, kStride, CP, false, lane);", ""),
            ("add_grad<CP>(gW1hr, dd, mt, 8 * nt, lane);", "")],
    },
}


def ptxas_lines(log: str, cp: int) -> list[str]:
    """The register and spill lines of the non-debug kernel built at `cp`."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = f"ILi{cp}ELb0E" in line
        elif keep and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--c", type=int, choices=(32, 33), default=33,
                    help="the layer width: 33 with one head (built at 48), or 32 with 4 heads")
    c = ap.parse_args(argv).c
    heads, cp = (1, 48) if c == 33 else (4, 32)

    if not torch.cuda.is_available():
        print("egcl_tile_sweep: no CUDA device")
        return 2
    import chip_smoke
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build, egcl, knn
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    dev = torch.device("cuda", 0)
    build.build_all([*VARIANTS, "knn_exact_warp"])
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
    calls = {"egcl_tile": lambda: egcl.egcl_layer(h, x, nbr, p, False, packed, True, "tile"),
             "egcl_backward_tile": lambda: eb.egcl_backward(h, x, nbr, p, dm, dx, False, packed,
                                                            "tile")}
    result = {}
    load = build.load
    with tempfile.TemporaryDirectory() as tmp:
        for source, variants in VARIANTS.items():
            with open(os.path.join(build.CSRC, f"{source}.cu")) as f:
                text = f.read()
            libs = {"default": None}
            for name, edits in variants.items():
                src = text
                for old, new in edits:
                    if old not in src:
                        raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
                    src = src.replace(old, new)
                path = os.path.join(tmp, f"{source}_v{len(libs)}.cu")
                with open(path, "w") as f:
                    f.write(src)
                res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
                                      path[:-3] + ".so", path], check=True, capture_output=True,
                                     text=True)
                print(f"{source} [{name}] ptxas at CP={cp}: "
                      f"{'; '.join(ptxas_lines(res.stdout + res.stderr, cp))}", flush=True)
                libs[name] = ctypes.CDLL(path[:-3] + ".so")
            times = {name: [] for name in libs}
            try:
                for _ in range(2):
                    for name, lib in libs.items():
                        build.load = load if lib is None else (
                            lambda nm, lib=lib, source=source: lib if nm == source else load(nm))
                        times[name].append(chip_smoke.cuda_ms(torch, calls[source], 5))
            finally:
                build.load = load
            result[source] = {name: min(v) for name, v in times.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"ms": result, "C": c, "CP": cp, "heads": heads, "B": b, "N": n, "K": k,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the SPFH kernels (B5) spend their time, on one NVIDIA GPU.

    python3 spfh_sweep.py

Builds timing-only variants of `csrc/spfh.cu` (the ballot kernel) and of
`csrc/spfh_redux.cu` (the kernel the wrapper launches), each one edit of
its source text compiled beside the package's own build, and times each
against its unedited kernel on the same inputs, in turns, at B=64, N=2048,
K=60, W=768 (the fused `register_fpfh` path's shapes, accurate mode).
Variants that drop work give wrong histograms: only their times mean
anything; each keeps the values it stops using live, so the compiler
cannot drop the work before them. Prints each variant's registers (ptxas)
and resident blocks an SM, then one JSON line of {kernel: {variant: ms}}
with the card's name and power limit. The unedited kernels are also timed
in fast mode and in accurate mode on inputs rounded to bf16 beforehand
(what the data costs, apart from where the rounding runs).
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

_BALLOTS = """        const int ca = __popc(__ballot_sync(0xffffffffu, on && ba == q));
        const int cp = __popc(__ballot_sync(0xffffffffu, on && bp == q));
        const int ct = __popc(__ballot_sync(0xffffffffu, on && ((tmask >> q) & 1)));
        total += ca;
        if (lane == q) { ha += ca; hp += cp; ht += ct; }"""
_NO_BALLOTS = """        if (on && q == 0) { ha += ba; hp += bp; ht += tmask; ++total; }"""
_SECTORS = """        bool prev = __fsub_rn(__fmul_rn(sec.cs[0], ty), __fmul_rn(sec.sn[0], tx)) >= 0.0f;
#pragma unroll
        for (int q = 0; q < kBins; ++q) {
          const float c = __fsub_rn(__fmul_rn(sec.cs[q + 1], ty), __fmul_rn(sec.sn[q + 1], tx));
          if (prev && c < 0.0f) tmask |= 1 << q;
          prev = c >= 0.0f;
        }"""
_NO_SECTORS = "        tmask = (ty >= 0.0f ? 1 : 0) | (tx >= 0.0f ? 2 : 0);"
_CENTERS = """    const float* pi = xb + (size_t)i * 3;
    const float* ni = nb + (size_t)i * 3;"""
_SMEM_CENTERS = """    const float* pi = wx + 3 * (i - S);
    const float* ni = wn + 3 * (i - S);"""
_KERNEL = "__global__ void spfh_kernel("
_REDUX_SECTORS = """  unsigned tmask = 0;
  bool prev = __fsub_rn(__fmul_rn(sec.cs[0], ty), __fmul_rn(sec.sn[0], tx)) >= 0.0f;
#pragma unroll
  for (int q = 0; q < kBins; ++q) {
    const float cq = __fsub_rn(__fmul_rn(sec.cs[q + 1], ty), __fmul_rn(sec.sn[q + 1], tx));
    if (prev && cq < 0.0f) tmask |= 1u << q;
    prev = cq >= 0.0f;
  }"""
_REDUX_NO_SECTORS = "  const unsigned tmask = (ty >= 0.0f ? 1u : 0u) | (tx >= 0.0f ? 2u : 0u);"
_PREFETCHED = "j[e] = k0 + lane + 32 * e < K ? j_next[e] : i;"
_LOADED = "j[e] = k0 + lane + 32 * e < K ? nbr_b[(size_t)i * K + k0 + lane + 32 * e] : i;"
_TWO_EDGES = "K <= 63 ? spfh_redux_kernel<6, 2>"
_ONE_EDGE = "K <= 63 ? spfh_redux_kernel<6, 1>"
MODES = ("accurate", "fast", "accurate on bf16-rounded inputs")
_WARPS = "constexpr int kWarps = 16;"

# {variant of the wrapper: (source, {name: [(old text, new text), ...]})}
VARIANTS = {
    "ballot": ("spfh", {
        "no ballots": [(_BALLOTS, _NO_BALLOTS)],
        "no theta sector loop": [(_SECTORS, _NO_SECTORS)],
        "chain only (no ballots, no theta loop)": [(_BALLOTS, _NO_BALLOTS),
                                                   (_SECTORS, _NO_SECTORS)],
        "bin_of by x0.5": [("__fdiv_rn(__fadd_rn(v, 1.0f), 2.0f)",
                            "__fmul_rn(__fadd_rn(v, 1.0f), 0.5f)")],
        "centers from shared memory": [(_CENTERS, _SMEM_CENTERS)],
        "4 warps a block": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
        "launch_bounds(256, 6)": [(_KERNEL, "__global__ void __launch_bounds__(256, 6) "
                                            "spfh_kernel(")],
        "launch_bounds(256, 8)": [(_KERNEL, "__global__ void __launch_bounds__(256, 8) "
                                            "spfh_kernel(")],
    }),
    "redux": ("spfh_redux", {
        "no theta sector loop": [(_REDUX_SECTORS, _REDUX_NO_SECTORS)],
        "no prefetch of the next pass's ids": [(_PREFETCHED, _LOADED)],
        "1 edge a lane a pass": [(_TWO_EDGES, _ONE_EDGE)],
        "1 edge a lane, 8 warps a block": [(_TWO_EDGES, _ONE_EDGE),
                                           (_WARPS, "constexpr int kWarps = 8;")],
        "8 warps a block": [(_WARPS, "constexpr int kWarps = 8;")],
        "12 warps a block": [(_WARPS, "constexpr int kWarps = 12;")],
    }),
}


def edited(text: str, name: str, edits) -> str:
    """`text` with each (old, new) replaced once; raises if an old text is
    not in it, so a variant never times the unedited kernel by mistake."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old[:60]!r}... is not in the source once")
        text = text.replace(old, new)
    return text


def build_variants(build, tmp):
    """{(wrapper variant, name): (library, ptxas's registers and spills)},
    one nvcc a variant, all started together."""
    jobs = {}
    for variant, (source, edits) in VARIANTS.items():
        with open(os.path.join(build.CSRC, f"{source}.cu")) as f:
            text = f.read()
        for name, ed in {"default": [], **edits}.items():
            path = os.path.join(tmp, f"v{len(jobs)}.cu")
            with open(path, "w") as f:
                f.write(edited(text, name, ed))
            jobs[variant, name] = path, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", path[:-3] + ".so",
                 path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, (path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        regs = "/".join(re.findall(r"Used (\d+) registers", out))
        spills = "/".join(re.findall(r"(\d+) bytes spill stores", out))
        libs[key] = (ctypes.CDLL(path[:-3] + ".so"),
                     f"{regs} registers, {spills} bytes of spill stores")
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("spfh_sweep: no CUDA device")
        return 2
    import chip_smoke
    from se3_equi_graph_registration_tpu_torch.ops import fpfh
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build, knn, spfh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    b, n, k, tile, w = 64, chip_smoke.FPFH_N, chip_smoke.FPFH_K, chip_smoke.FPFH_TILE, \
        chip_smoke.FPFH_WINDOW
    xs = chip_smoke.surface_clouds(torch, dev, b)
    nbr = knn.knn_chunked(xs, k, tile, w)
    normals = fpfh.estimate_normals_window(xs, nbr[..., :chip_smoke.FPFH_KN]).contiguous()
    inputs = {"accurate": (xs, normals, True), "fast": (xs, normals, False),
              "accurate on bf16-rounded inputs": (spfh.round_bf16(xs), spfh.round_bf16(normals),
                                                  True)}
    load = build.load

    def use(variant, name):
        """Route the wrapper's load of the variant's source to this build."""
        source, lib = VARIANTS[variant][0], libs[variant, name][0]
        build.load = lambda nm: lib if nm == source else load(nm)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(build, tmp)
        try:
            for (variant, name), (_, regs) in libs.items():
                use(variant, name)
                per_sm, grid = spfh.occupancy(variant, b, n, k, tile, w, dev)
                print(f"{VARIANTS[variant][0]}[{name}]: ptxas {regs}; {per_sm} blocks an SM, "
                      f"grid {grid} blocks = {grid / (per_sm * sms):.2f} waves", flush=True)
            # each variant in accurate mode; the unedited kernels also in fast
            # mode and in accurate mode on inputs rounded to bf16 beforehand
            runs = [(variant, name, mode) for variant, name in libs
                    for mode in (MODES if name == "default" else ("accurate",))]
            times = {run: [] for run in runs}
            for _ in range(3):
                for variant, name, mode in runs:
                    use(variant, name)
                    x, nrm, accurate = inputs[mode]
                    times[variant, name, mode].append(chip_smoke.cuda_ms(
                        torch, lambda: spfh.spfh(x, nrm, nbr, tile, w, accurate, variant), 20))
        finally:
            build.load = load
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    out = {}
    for (variant, name, mode), ts in times.items():
        out.setdefault(VARIANTS[variant][0], {})[
            name if mode == "accurate" else f"{name}, {mode}"] = min(ts)
    print(json.dumps({"spfh_ms": out, "shape": dict(B=b, N=n, K=k, W=w),
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

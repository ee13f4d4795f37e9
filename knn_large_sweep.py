#!/usr/bin/env python3
"""Where the large-k exact k-NN kernel (B1 at 128 < k <= 1024) spends its
time, on one NVIDIA GPU.

    python3 knn_large_sweep.py

Builds timing variants of `csrc/knn_exact_large.cu`, each one edit of its
source text compiled beside the package's own build (one nvcc a variant,
all started together), and times each against the unedited kernel on the
same inputs, in turns, at B=64 clouds, N=2048, k=300, over a window of 768
(the fused `register_fpfh` path's) and over the whole cloud (its default
'approx' path's), on `chip_smoke.py`'s curve-sorted and unsorted surface
clouds. Variants that drop work give wrong lists: only their times mean
anything, and each keeps the values it stops using live; the others are
also held bit for bit against the plain version. One variant reads the
SM's clock at the phase boundaries and prints each phase's share of a
warp's cycles. Prints each variant's registers and spills (ptxas), then
one JSON line of {variant: {shape: ms}} with the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

K = 300
_COMPACT = "    // compact: exactly K keys"
_PASSES_ONLY = """    if (K > 0) {     // timing only: the passes, then the next query
      if (lane == 0 && active && prefix == 1u && mask == 2u) out[0] = static_cast<int>(need);
      continue;
    }
"""
_PHASE_SYMBOLS = """__device__ unsigned long long g_phase_cycles[4];
extern "C" int knn_exact_large_phases(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles)));
}

namespace {
"""
_OUT = ("    for (int e = lane; e < K; e += 32) "
        "o[e] = static_cast<int>(static_cast<unsigned>(keys[e]));\n    __syncwarp();\n")
_SORT = "    radix_sort(keys, other, sort_hist, K);\n"
_OR_RANKS = """      const unsigned d = static_cast<unsigned>(key >> shift) & 0xffu;
      if (valid) atomicOr(peers_of + d, 1u << lane);
      __syncwarp();
      const unsigned peers = valid ? peers_of[d] : 0u;
"""
_MATCH_RANKS = ("      const unsigned d = valid ? static_cast<unsigned>(key >> shift) & 0xffu "
                ": 0x100u;\n      const unsigned peers = __match_any_sync(kFull, d);\n")
_CLEAR = "          peers_of[d] = 0u;\n"
_OUT_CLOCKED = _OUT + """    if (lane == 0) {
      const long long t_end = clock64();
      atomicAdd(&g_phase_cycles[0], static_cast<unsigned long long>(t_select - t_start));
      atomicAdd(&g_phase_cycles[1], static_cast<unsigned long long>(t_compact - t_select));
      atomicAdd(&g_phase_cycles[2], static_cast<unsigned long long>(t_sort - t_compact));
      atomicAdd(&g_phase_cycles[3], static_cast<unsigned long long>(t_end - t_sort));
    }
"""
PHASES = ("select (radix passes)", "compact", "sort", "ids out")
VARIANTS = {
    "all 4 passes (no early end)": [("done = in_bin == need;", "done = false;")],
    "2 groups a step": [("constexpr int kGroup = 4;", "constexpr int kGroup = 2;")],
    "8 groups a step": [("constexpr int kGroup = 4;", "constexpr int kGroup = 8;")],
    "sort ranks by match_any": [(_OR_RANKS, _MATCH_RANKS), (_CLEAR, "")],
    "chunks of 2048": [("constexpr int kChunk = 1024;", "constexpr int kChunk = 2048;")],
    "no sort (timing only)": [(_SORT, "")],
    "passes only (timing only)": [(_COMPACT, _PASSES_ONLY + _COMPACT)],
    "phase clocks": [
        ("\nnamespace {\n", "\n" + _PHASE_SYMBOLS),
        ("    const bool active = ql < bq.end;\n",
         "    const bool active = ql < bq.end;\n    const long long t_start = clock64();\n"),
        (_COMPACT, "    const long long t_select = clock64();\n" + _COMPACT),
        ("    if (!active) continue;\n    __syncwarp();\n",
         "    if (!active) continue;\n    __syncwarp();\n"
         "    const long long t_compact = clock64();\n"),
        (_SORT, _SORT + "    const long long t_sort = clock64();\n"),
        (_OUT, _OUT_CLOCKED)],
}
TIMING_ONLY = tuple(name for name in VARIANTS if name.endswith("(timing only)"))


def edited(text: str, name: str, edits) -> str:
    """`text` with each (old, new) replaced once; raises if an old text is
    not in it, so a variant never times the unedited kernel by mistake."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old[:60]!r}... is not in the source once")
        text = text.replace(old, new)
    return text


def build_variants(build, tmp):
    """{name: (library, ptxas's registers and spills)}, one nvcc a variant,
    all started together."""
    with open(os.path.join(build.CSRC, "knn_exact_large.cu")) as f:
        text = f.read()
    jobs = {}
    for name, ed in {"default": [], **VARIANTS}.items():
        path = os.path.join(tmp, f"v{len(jobs)}.cu")
        with open(path, "w") as f:
            f.write(edited(text, name, ed))
        jobs[name] = path, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = "/".join(re.findall(r"Used (\d+) registers", out))
        spills = "/".join(re.findall(r"(\d+) bytes spill stores", out))
        libs[name] = (ctypes.CDLL(path[:-3] + ".so"), f"{regs} registers, {spills} bytes of "
                      "spill stores")
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("knn_large_sweep: no CUDA device")
        return 2
    import chip_smoke
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build, knn

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    b, tile, w = 64, chip_smoke.FPFH_TILE, chip_smoke.FPFH_WINDOW
    shapes = {f"W={w}": (chip_smoke.surface_clouds(torch, dev, b), w),
              "whole cloud": (chip_smoke.surface_clouds(torch, dev, b, sort=False), None)}
    load = build.load

    def use(name):
        lib = libs[name][0]
        build.load = lambda nm: lib if nm == "knn_exact_large" else load(nm)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(build, tmp)
        try:
            for name, (_, regs) in libs.items():
                print(f"knn_exact_large[{name}]: ptxas {regs}", flush=True)
            for name in libs:
                if name in TIMING_ONLY:
                    continue
                use(name)
                for shape, (x, win) in shapes.items():
                    got = knn.knn_window(x, K, tile, win, packed=False)
                    ref = knn.knn_window_plain(x, K, tile, win, packed=False)
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{name}, {shape}: lists differ from the plain "
                                             "version")
            print("every variant that keeps the work: identical to the plain version",
                  flush=True)
            times = {(name, shape): [] for name in libs for shape in shapes}
            for _ in range(3):
                for name, shape in times:
                    use(name)
                    x, win = shapes[shape]
                    times[name, shape].append(chip_smoke.cuda_ms(
                        torch, lambda: knn.knn_window(x, K, tile, win, packed=False), 20))
            lib = libs["phase clocks"][0]
            use("phase clocks")
            for shape, (x, win) in shapes.items():
                cycles = (ctypes.c_ulonglong * 4)()
                lib.knn_exact_large_phases.argtypes = [ctypes.c_void_p]
                base = (ctypes.c_ulonglong * 4)()
                assert lib.knn_exact_large_phases(ctypes.addressof(base)) == 0
                knn.knn_window(x, K, tile, win, packed=False)
                torch.cuda.synchronize()
                assert lib.knn_exact_large_phases(ctypes.addressof(cycles)) == 0
                spent = [c - c0 for c, c0 in zip(cycles, base)]
                print(f"phase clocks, {shape}: " + ", ".join(
                    f"{p} {100 * c / sum(spent):.1f}%" for p, c in zip(PHASES, spent))
                    + f" of {sum(spent) / (b * 2048):.0f} cycles a query (a warp's clock)")
        finally:
            build.load = load
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    out = {}
    for (name, shape), ts in times.items():
        out.setdefault(name, {})[shape] = min(ts)
    print(json.dumps({"knn_exact_large_ms": out, "shape": dict(B=b, N=2048, K=K),
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

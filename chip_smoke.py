#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases egcl,serve,train,fpfh]

Builds the CUDA kernels from `se3_equi_graph_registration_tpu_torch/csrc`
(one nvcc per source, in parallel) and holds each against its plain PyTorch
version on the card at the main paths' shapes; the EGCL forward has two
kernels (the bf16 tensor-core tile kernel for fast mode at C=32, the SIMT
kernel for accurate mode and other widths) and both are held. Then it
drives the three main paths, each with the launch counters set to 0 just
before it and read just after (`--phases` runs a subset: `egcl` is the
k-NN and EGCL forward kernel checks alone, for iterating on a kernel; with
no argument everything runs):
- serving at the full `fast_tpu_config` (N=2048, k=16, C=32, 3 layers, 4
  heads, top_k=128), seeded random weights: `Registrar.register` and
  `BatchingServer`, checked against the same Registrar on the CPU;
- training: `make_train_step` with Adam at B=64 (2 knn, 6 EGCL forward and
  6 EGCL backward launches per step), an accurate step checked against the
  same step on the CPU, and fast-against-accurate gradients printed;
- the checkpoint-free pipeline at full width (N=2048, k_normals 30, k_fpfh
  60, tile 128, window 768, chunked keys, top_m 512, 512 hypotheses, 5 IRLS
  and 10 ICP steps, quaternion Kabsch): `register_fpfh` at 4 branches and 1
  (2 chunked k-NN and 2 SPFH launches per call, no B1) against the same
  call on the CPU on a seeded bumpy surface pair, then
  `register_fpfh_batch` at B=8 and 32, and a profile of one b=1 call.
Any failed check raises (non-zero exit, no result line). The last line is
one JSON object with the device.

Tolerances (kernel vs its plain version, same inputs, on the card):
- knn: neighbor sets equal row by row up to near-ties (d² within 2⁻¹²
  relative of the row's k-th d²); the two compute d² with the same
  round-to-nearest operations in the same order, so sets normally match
  exactly.
- egcl, h′: max |Δ| ≤ tol · max|ref h′|; coordinates through their update
  u = x′ − x: max |Δu| ≤ tol · max|ref u| + ε₃₂ · max|x|, the last term
  being the fp32 spacing at which x′ = x + u can be read back. The update
  is ~4e-3 against |x| ~1.5 at the served weights, so a check on x′ itself
  would pass a kernel that left the coordinates unchanged.
- egcl accurate: tol 1e-4 (fp32; only summation order differs: sequential
  FMAs against cuBLAS; measured 2.4e-7 on h′).
- egcl fast: tol 2e-2 on h′ and 1e-2 on u (measured 2.2e-3 on h′ and
  5.5e-4 on u at C=32): both round the same operands to bf16, but a sum that
  differs in its last fp32 bit can round to the next bf16 value (2⁻⁸
  relative), and that propagates.
- register() card vs CPU: ‖ΔR‖_F/√2 ≤ 2e-3, |Δt| ≤ 2e-3 m, covariance and
  similarity mean within 2e-2 relative (fast mode on both sides).
- egcl agg_m output: as h′ (1e-4 accurate, 2e-2 fast, of its scale).
- egcl tile kernel: one bare mma tile against a matrix product of the same
  bf16 values, 1e-5 of its scale (fp32 sums in another order); its per-edge
  stages s1 and m against the plain version's as h′ (2e-2 of the scale);
  the layer as egcl fast, in every case (K=12, 16, 20, head widths 8 and
  32, repeated points, B=1, with and without agg_m); tile against SIMT (the
  same function in two orders of summation) at twice the fast tolerances.
- egcl_backward, dh, dx and each of the 11 parameter gradients, relative
  to the tensor's max-abs scale: accurate 1e-4 (fp32; the neighbor and
  parameter sums are atomic, so their order changes from run to run, and
  a parameter gradient sums 2.1 M edges; measured ≤ 3.1e-6); fast 5e-3
  (a sum that differs in its last fp32 bit can round an operand to the
  next bf16 value, 2⁻⁸ relative, as in the forward; measured ≤ 2e-4).
  Two cases in each mode: random dagg_m and dagg_x at the seeded weights,
  and the coordinate path alone (dagg_m = 0, the coord output drawn at
  O(1/√C) instead of the init's 1e-3 gain). At the seeded weights the
  terms through the coordinate MLP (dm += Wc0ᵀ·dcm_in, drel += dax·scale)
  move every tensor by 1e-5 to 4e-4 of its scale, under the tolerances; in
  the second case they carry all of it.
- train, accurate step at B=2, card vs CPU: loss within 1e-4 relative;
  every parameter's gradient at cosine ≥ 0.9999 and relative L2 ≤ 1e-4
  (measured 1.6e-6); post-Adam parameters within 1e-6 where the gradient
  exceeds 1e-3 of its tensor's max, and within 2·lr everywhere (Adam's
  first update is ±lr·g/(|g|+ε), so an element whose gradient sits at the
  noise floor may flip sign).
- train, fast against accurate on the card: only finiteness is checked.
  At these untrained weights the similarity softmax saturates, and the two
  modes are different functions (the reference's gradient budget,
  BASELINE.md); the table is printed.
- knn_chunked (B4): lists identical to the plain version (same integer keys
  from the same round-to-nearest d²). Its neighbor-set agreement with B1
  packed is printed. B1 at k=60, W=768: as above (near-ties).
- spfh (B5), both modes: distances within 1e-6 relative; at most 1e-4 of
  the edge-channels in another bin (fp noise at a boundary); SPFH values
  within 1e-3 (of 100 per channel) where a center's counts all agree.
- TF32 enabled: the normals and the branch verification equal their
  TF32-off values within 1e-6 (they use no matmul).
- register_fpfh card vs CPU, same seed: both within 0.5 deg and 5 mm of the
  ground truth; ‖ΔR‖_F/√2 ≤ 2e-3 and |Δt| ≤ 2e-3 m between them. The
  batch: all but at most one pair within 0.5 deg and 5 mm. The gap between
  card and CPU is fp noise amplified by plane ICP, whose end state on
  independently sampled surfaces wanders at the 1e-3 level: over 12 seeded
  pairs at 4 branches and 1 it measured 1.2e-4 to 3.3e-3 (4 of 24 above
  2e-3) while every run stayed within 0.19 deg and 1.8 mm of the truth
  (H100 80GB HBM3, 700 W). The check runs on pair 6 (2.8e-4 at both).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
BWD_TOL_ACCURATE = 1e-4
BWD_TOL_FAST = 5e-3
# csrc/spfh.cu, fp32 operations per edge: d and d² (8), sqrt and d̂ (5), the
# two source-pick dots (12), the v cross, norm and divides (20), w (9), four
# Darboux dots (20), α/φ bins (12), 12 θ sector tests (36) and their
# compares (24), the distance select (1)
SPFH_EDGE_OPS = 147
# the checkpoint-free pipeline's full width (register_fpfh defaults, the
# fused/chunked fast mode): N, k_normals, k_fpfh, tile, window
FPFH_N, FPFH_KN, FPFH_K, FPFH_TILE, FPFH_WINDOW = 2048, 30, 60, 128, 768
FPFH_BATCHES = (8, 32)      # register_fpfh_batch sizes timed


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound_ms(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profile_call(torch, call, label):
    """Device time by kernel over one warm call under torch.profiler, and
    the device-busy share of that call's wall time (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if total_ms == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile {label}: wall {wall_ms:.2f} ms (profiler on), device "
        f"busy {total_ms:.2f} ms ({100 * total_ms / wall_ms:.1f}%), {len(dev)} kernels")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")


def egcl_errors(torch, got, ref, x, accurate):
    """(max|Δh′|, max|Δu|, scale h′, scale u) for u = x′ − x; raises beyond
    the stated tolerances."""
    (gh, gx), (rh, rx) = got, ref
    tol_h, tol_u = (1e-4, 1e-4) if accurate else (2e-2, 1e-2)
    eh, sh = (gh - rh).abs().max().item(), rh.abs().max().item()
    eu, su = ((gx - x) - (rx - x)).abs().max().item(), (rx - x).abs().max().item()
    ulp = torch.finfo(torch.float32).eps * x.abs().max().item()
    check(su > 0, "egcl: the plain version moved no coordinate")
    check(eh <= tol_h * sh and eu <= tol_u * su + ulp,
          f"egcl accurate={accurate}: max|Δh′| {eh} (scale {sh}, tol {tol_h}), "
          f"max|Δu| {eu} (scale {su}, tol {tol_u}, read-back {ulp})")
    return eh, eu, sh, su


def backward_errors(got, ref, accurate, what):
    """{name: (max|Δ|, max|ref|)} over dh, dx and the 11 parameter gradients
    of egcl_backward against its plain version; raises beyond the stated
    tolerances (module docstring)."""
    (gh, gx, gg), (rh, rx, rg) = got, ref
    pairs = dict(dh=(gh, rh), dx=(gx, rx), **{k: (gg[k], rg[k]) for k in rg})
    tol = BWD_TOL_ACCURATE if accurate else BWD_TOL_FAST
    errs = {}
    for name, (a, b) in pairs.items():
        scale = b.abs().max().item()
        errs[name] = ((a - b).abs().max().item(), scale)
        check(scale > 0, f"egcl_backward {what}: plain {name} is all zero")
    worst = max(errs, key=lambda k: errs[k][0] / errs[k][1])
    check(all(e <= tol * s for e, s in errs.values()),
          f"egcl_backward {what} accurate={accurate}: {worst} max|Δ| {errs[worst][0]} against "
          f"scale {errs[worst][1]} (tol {tol} of the scale)")
    return errs


def egcl_backward_phase(torch, p, h, xs, nbr, gen):
    """B2 with agg_m (the tile kernel in fast mode, the SIMT kernel in
    accurate), then B3 against their plain versions, both modes, at the main
    path's shapes, on random cotangents and on the coordinate path
    alone; then C=33 with one head. Returns the kernel row."""
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    dev = h.device
    b, n, c = h.shape
    k = nbr.shape[-1]
    packed = egcl.pack_for_kernels(p)
    dagg_m = torch.randn(b, n, c, generator=gen).to(dev)
    dagg_x = torch.randn(b, n, 3, generator=gen).to(dev)
    # the coordinate path alone: every cotangent reaches the edge MLP through
    # dm = Wc0ᵀ·dcm_in, and drel's dax·scale term is at full weight
    pc = p._replace(wc1=torch.randn(1, c, generator=gen).to(dev) / c ** 0.5)
    packed_c, zero_m = egcl.pack_for_kernels(pc), torch.zeros_like(dagg_m)
    stats = {}
    for accurate in (True, False):
        name = "accurate" if accurate else "fast"
        gh, gx, gm = egcl.egcl_layer(h, xs, nbr, p, accurate, packed, return_aggm=True)
        torch.cuda.synchronize()
        rh, rx, rm = egcl.egcl_layer_plain(h, xs, nbr, p, accurate, return_aggm=True)
        egcl_errors(torch, (gh, gx), (rh, rx), xs, accurate)
        em, sm = (gm - rm).abs().max().item(), rm.abs().max().item()
        check(em <= (1e-4 if accurate else 2e-2) * sm,
              f"egcl agg_m accurate={accurate}: max|Δ| {em} against scale {sm}")
        got = eb.egcl_backward(h, xs, nbr, p, dagg_m, dagg_x, accurate, packed)
        torch.cuda.synchronize()
        ref = eb.egcl_backward_plain(h, xs, nbr, p, dagg_m, dagg_x, accurate)
        errs = backward_errors(got, ref, accurate, "random cotangents")
        errs_c = backward_errors(
            eb.egcl_backward(h, xs, nbr, pc, zero_m, dagg_x, accurate, packed_c),
            eb.egcl_backward_plain(h, xs, nbr, pc, zero_m, dagg_x, accurate), accurate,
            "coordinate path")
        ms_aggm = cuda_ms(torch, lambda: egcl.egcl_layer(h, xs, nbr, p, accurate, packed,
                                                          return_aggm=True), 10)
        ms = cuda_ms(torch, lambda: eb.egcl_backward(h, xs, nbr, p, dagg_m, dagg_x,
                                                      accurate, packed), 5)
        plain = cuda_ms(torch, lambda: eb.egcl_backward_plain(h, xs, nbr, p, dagg_m,
                                                               dagg_x, accurate), 2)
        stats[name] = (ms, plain, max(e for e, _ in (*errs.values(), *errs_c.values())))
        for case, es in (("random cotangents", errs), ("coordinate path", errs_c)):
            worst = max(es, key=lambda q: es[q][0] / es[q][1])
            log(f"egcl_backward[{name}, {case}] B={b} N={n} C={c} K={k}: worst {worst} "
                f"rel {es[worst][0] / es[worst][1]:.3g}; rel per tensor "
                + ", ".join(f"{q} {e / s_:.2g}" for q, (e, s_) in es.items()))
        log(f"egcl_backward[{name}]: agg_m max|Δ| {em:.3g} (rel {em / sm:.3g}); kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms; egcl with agg_m {ms_aggm:.3f} ms")
    wh = p.head_width
    fwd_edge = 2 * c * (c + 12) + 2 * c * wh + 2 * c * c + 2 * c + 12 * c
    bwd_edge = (2 * c * c * 4 + 2 * c * wh * 2 + 2 * 12 * c * 2 + 2 * c   # products
                + 20 * c + 150)                                          # LN, SiLU, geometry
    center = 3 * 2 * c * c
    ops = b * n * (k * (fwd_edge + bwd_edge) + center)
    nbytes = 4 * b * n * (2 * c + 6 + k) + 2 * 4 * b * n * (c + 3) + packed.simt.numel() * 4
    ms, plain, err = stats["fast"]
    bb, bby = bound_ms(nbytes, ops, PEAK_BF16)
    log(f"egcl_backward bound: {ops / (b * n * k):.0f} FLOP/edge; fast vs bf16 peak "
        f"{bb:.4f} ms, accurate vs fp32 peak {bound_ms(nbytes, ops, PEAK_FP32)[0]:.4f} ms")

    m33 = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=1)
    p33 = egcl.params_from_layer(m33.to(dev).gcl_0)
    b33 = min(8, b)
    h33 = torch.randn(b33, n, 33, generator=gen).to(dev)
    x33, nbr33 = xs[:b33].contiguous(), nbr[:b33].contiguous()
    dm33 = torch.randn(b33, n, 33, generator=gen).to(dev)
    dx33 = dagg_x[:b33].contiguous()
    for accurate in (True, False):
        errs = backward_errors(
            eb.egcl_backward(h33, x33, nbr33, p33, dm33, dx33, accurate),
            eb.egcl_backward_plain(h33, x33, nbr33, p33, dm33, dx33, accurate), accurate,
            "C=33")
        worst = max(errs, key=lambda q: errs[q][0] / errs[q][1])
        log(f"egcl_backward[C=33, 1 head, accurate={accurate}] B={b33}: worst {worst} "
            f"rel {errs[worst][0] / errs[worst][1]:.3g}")
    return dict(name="egcl_backward", route="cuda",
                source="se3_equi_graph_registration_tpu_torch/csrc/egcl_backward.cu",
                replaces="se3_equi_graph_registration_tpu/ops/pallas/egcl_backward.py:53",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bb,
                bound_by=bby, library_ms=None)


def knn_compare(x, ref, got, rel=2.0 ** -12):
    """Rows whose sets differ; raises unless every swap is a near-tie.
    Also returns the largest |Δ d²| between the rows' sorted k-NN d²."""
    xs, ref, got = x.cpu().double().numpy(), ref.cpu().numpy(), got.cpu().numpy()
    rs, gs = np.sort(ref, -1), np.sort(got, -1)
    bad = np.argwhere(np.any(rs != gs, -1))
    for b, r in bad:
        sym = list(set(ref[b, r].tolist()) ^ set(got[b, r].tolist()))
        d2 = ((xs[b, sym] - xs[b, r]) ** 2).sum(-1)
        kth = ((xs[b, ref[b, r]] - xs[b, r]) ** 2).sum(-1).max()
        check(np.all(np.abs(d2 - kth) <= rel * max(kth, 1e-30)),
              f"knn mismatch beyond near-ties at cloud {b} row {r}")
    d_ref = np.sort(((np.take_along_axis(xs, ref.reshape(ref.shape[0], -1)[..., None], 1)
                      .reshape(ref.shape + (3,)) - xs[:, :, None]) ** 2).sum(-1), -1)
    d_got = np.sort(((np.take_along_axis(xs, got.reshape(got.shape[0], -1)[..., None], 1)
                      .reshape(got.shape + (3,)) - xs[:, :, None]) ** 2).sum(-1), -1)
    return len(bad), float(np.abs(d_ref - d_got).max())


PHASES = ("egcl", "serve", "train", "fpfh")
ROW_ORDER = ("knn_window", "egcl_layer", "egcl_backward", "knn_chunked", "spfh")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES) + " (default: all)")
    phases = tuple(ap.parse_args(argv).phases.split(","))
    if not phases or any(ph not in PHASES for ph in phases):
        ap.error(f"--phases takes names from {PHASES}")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build
    from se3_equi_graph_registration_tpu_torch.train import engine

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log(smi[0] if smi else "nvidia-smi: no output")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")

    rows = run(torch, dev, engine.fast_tpu_config(), bsz=64, phases=phases)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def record_launches(rows, path, launches):
    """Write one path's launch counts {kernel name: n} into the rows."""
    for name, n in launches.items():
        if name in rows:
            rows[name].setdefault("launches_by_path", {})[path] = n
            rows[name]["launches"] = sum(rows[name]["launches_by_path"].values())


def reset_egcl_counters(egcl):
    egcl.egcl_layer.launches = 0
    egcl.egcl_layer.launches_by_variant = {"tile": 0, "simt": 0}


def run(torch, dev, cfg, bsz, phases=PHASES):
    """The chosen phases at `cfg` with `bsz` pairs (clouds, for B4 and B5);
    returns the kernel rows of the phases that ran, in ROW_ORDER."""
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops import morton
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
    from se3_equi_graph_registration_tpu_torch.train import checkpoints, engine

    n, k, c, tile, window = cfg.num_nodes, cfg.k, cfg.hidden_nf, cfg.egnn_tile, cfg.egnn_window
    rng = np.random.default_rng(0)
    pb = make_pair_batch(rng, batch=bsz, n=n, feat_dim=cfg.in_node_nf)
    x = torch.from_numpy(pb.src_pts).to(dev)
    _, xs, _ = morton.sort_by_curve(torch.zeros(bsz, n, 1, device=dev), x)
    xs = xs.contiguous()
    gen = torch.Generator().manual_seed(0)
    cpu_model = engine.build_model(cfg, "eval_fusion", device="cpu")
    checkpoints.init_weights(cpu_model, gen)
    sd = cpu_model.state_dict()
    layer_model = engine.build_model(cfg, "eval_fusion", device=dev)
    layer_model.load_state_dict(sd)
    p = egcl.params_from_layer(layer_model.egnn.gcl_0)
    h = torch.randn(bsz, n, c, generator=gen).to(dev)
    nbr = knn.knn_window(xs, k, tile=tile, window=window, packed=True)
    rows = {}

    if "egcl" in phases:
        rows["knn_window"] = knn_phase(torch, xs, k, tile, window)
        rows["egcl_layer"] = egcl_phase(torch, p, h, xs, nbr, gen)
    if "serve" in phases:
        serve_phase(torch, dev, cfg, bsz, sd, rows)
    if "train" in phases:
        rows["egcl_backward"] = egcl_backward_phase(torch, p, h, xs, nbr, gen)
        train_phase(torch, dev, cfg, bsz, rows)
    if "fpfh" in phases:
        for row in fpfh_kernel_phase(torch, dev, bsz):
            rows[row["name"]] = row
        register_fpfh_phase(torch, dev, rows)
    return [rows[name] for name in ROW_ORDER if name in rows]


def knn_phase(torch, xs, k, tile, window):
    """B1 against its plain version, packed (served) then exact; its row."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn

    bsz, n, _ = xs.shape
    knn_stats = {}
    for mode in ("packed", "exact"):
        kw = dict(tile=tile, window=window, packed=mode == "packed")
        got = knn.knn_window(xs, k, **kw)
        torch.cuda.synchronize()
        ref = knn.knn_window_plain(xs, k, **kw)
        n_bad, err = knn_compare(xs, ref, got)
        ms = cuda_ms(torch, lambda: knn.knn_window(xs, k, **kw), 20)
        plain = cuda_ms(torch, lambda: knn.knn_window_plain(xs, k, **kw), 5)
        knn_stats[mode] = (ms, plain, err)
        log(f"knn[{mode}] B={bsz} N={n} k={k} T={tile} W={window}: rows differing "
            f"{n_bad} (near-ties), max|Δd²| {err:.3g}, kernel {ms:.4f} ms, plain {plain:.3f} ms")
    nbytes = xs.numel() * 4 + bsz * n * k * 4
    kb, kby = bound_ms(nbytes, bsz * n * window * 8, PEAK_FP32)
    ms, plain, err = knn_stats["packed"]
    return dict(name="knn_window", route="cuda",
                source="se3_equi_graph_registration_tpu_torch/csrc/knn.cu",
                replaces="se3_equi_graph_registration_tpu/ops/pallas/knn_kernel.py:26",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=kb, bound_by=kby, library_ms=None)


def egcl_tile_checks(torch, p, h, xs, nbr, gen):
    """The tile kernel from the bottom up: one bare mma tile against a
    matrix product, its per-edge stages (first layer, then the chain to the
    LayerNorm) against the plain version's, then the layer in every case the
    kernel has a path for."""
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    dev = h.device
    a = torch.randn(16, 16, generator=gen).to(torch.bfloat16).to(dev)
    w = torch.randn(32, 16, generator=gen).to(dev)
    got = egcl.mma_tile_probe(a, w)
    torch.cuda.synchronize()
    ref = a.double() @ w[:8].to(torch.bfloat16).double().T
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    check(err <= 1e-5 * scale, f"mma tile: max|Δ| {err} against scale {scale}")
    log(f"egcl tile: one mma.m16n8k16 tile vs matmul max|Δ| {err:.3g} (scale {scale:.3g})")

    b8 = min(8, h.shape[0])
    h8, x8, nbr8 = h[:b8].contiguous(), xs[:b8].contiguous(), nbr[:b8].contiguous()
    s1, m = egcl.egcl_tile_stages(h8, x8, nbr8, p)
    torch.cuda.synchronize()
    _, rs1, rm, _ = egcl.edge_stages_plain(h8, x8, nbr8, p, accurate=False)
    for name, g_, r_ in (("s1 (first layer)", s1, rs1), ("m (chain to LayerNorm)", m, rm)):
        err, scale = (g_ - r_).abs().max().item(), r_.abs().max().item()
        check(err <= 2e-2 * scale, f"egcl tile stage {name}: max|Δ| {err} against scale {scale}")
        log(f"egcl tile stage {name} B={b8}: max|Δ| {err:.3g} (rel {err / scale:.3g})")

    p1 = egcl.params_from_layer(EGNN(in_node_nf=32, hidden_nf=32, out_node_nf=32, n_layers=1,
                                     num_heads=1).to(dev).gcl_0)
    x_dup = x8.clone()
    x_dup[:, 1::2] = x_dup[:, ::2]                 # every point twice: degenerate frames
    k = nbr.shape[-1]
    wide = torch.cat([nbr8, nbr8.flip(1)[..., :4]], dim=-1).contiguous()
    cases = [(f"K={k}, head width {p.head_width}", h8, x8, nbr8, p),
             ("K=12", h8, x8, nbr8[..., :12].contiguous(), p),
             (f"K={k + 4} (two row tiles)", h8, x8, wide, p),
             ("head width 32", h8, x8, nbr8, p1),
             ("repeated points", h8, x_dup, nbr8, p),
             ("B=1", h8[:1].contiguous(), x8[:1].contiguous(), nbr8[:1].contiguous(), p)]
    for name, h_, x_, nbr_, p_ in cases:
        check(egcl.egcl_variant(h_.shape[-1], nbr_.shape[-1], p_.head_width, False) == "tile",
              f"egcl tile case {name} is not routed to the tile kernel")
        gh, gx, gm = egcl.egcl_layer(h_, x_, nbr_, p_, False, return_aggm=True)
        gh2, gx2 = egcl.egcl_layer(h_, x_, nbr_, p_, False)
        torch.cuda.synchronize()
        check(torch.equal(gh, gh2) and torch.equal(gx, gx2),
              f"egcl tile case {name}: asking for agg_m changed h′ or x′")
        rh, rx, rm = egcl.egcl_layer_plain(h_, x_, nbr_, p_, False, return_aggm=True)
        check(all(bool(torch.isfinite(t_).all()) for t_ in (gh, gx, gm)),
              f"egcl tile case {name}: non-finite output")
        eh, eu, sh, su = egcl_errors(torch, (gh, gx), (rh, rx), x_, accurate=False)
        em, sm = (gm - rm).abs().max().item(), rm.abs().max().item()
        check(em <= 2e-2 * sm, f"egcl tile case {name}: agg_m max|Δ| {em} against scale {sm}")
        log(f"egcl tile case {name} B={h_.shape[0]}: rel h′ {eh / sh:.3g}, u {eu / su:.3g}, "
            f"agg_m {em / sm:.3g}; same with and without agg_m")


def egcl_phase(torch, p, h, xs, nbr, gen):
    """B2 against its plain version: the tile kernel from the bottom up,
    then both kernels at the main path's shape in fast mode and the SIMT
    kernel in accurate mode, tile against SIMT, and C=33 with one head.
    Returns the kernel row."""
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    dev = h.device
    bsz, n, c = h.shape
    k = nbr.shape[-1]
    egcl_tile_checks(torch, p, h, xs, nbr, gen)
    packed = egcl.pack_for_kernels(p)
    stats, outs = {}, {}
    for name, accurate, variant in (("accurate", True, "simt"), ("fast tile", False, "tile"),
                                    ("fast simt", False, "simt")):
        reset_egcl_counters(egcl)
        gh, gx = egcl.egcl_layer(h, xs, nbr, p, accurate, packed, variant=variant)
        torch.cuda.synchronize()
        check(egcl.egcl_layer.launches_by_variant == {"tile": 0, "simt": 0, variant: 1},
              f"egcl[{name}] launched {egcl.egcl_layer.launches_by_variant}")
        ref = egcl.egcl_layer_plain(h, xs, nbr, p, accurate)
        eh, eu, sh, su = egcl_errors(torch, (gh, gx), ref, xs, accurate)
        ms = cuda_ms(torch, lambda: egcl.egcl_layer(h, xs, nbr, p, accurate, packed,
                                                     variant=variant), 10)
        plain = cuda_ms(torch, lambda: egcl.egcl_layer_plain(h, xs, nbr, p, accurate), 3)
        stats[name], outs[name] = (ms, plain, max(eh, eu)), (gh, gx)
        log(f"egcl[{name}] B={bsz} N={n} C={c} K={k}: max|Δh′| {eh:.3g} (rel {eh / sh:.3g}), "
            f"max|Δu| {eu:.3g} (rel {eu / su:.3g} of the update scale {su:.3g}), "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
    # tile against SIMT: one function, two orders of summation
    (th, tx), (sh_, sx) = outs["fast tile"], outs["fast simt"]
    dh, hs = (th - sh_).abs().max().item(), sh_.abs().max().item()
    du, us = ((tx - xs) - (sx - xs)).abs().max().item(), (sx - xs).abs().max().item()
    ulp = torch.finfo(torch.float32).eps * xs.abs().max().item()
    check(dh <= 2 * 2e-2 * hs and du <= 2 * 1e-2 * us + ulp,
          f"egcl tile vs simt: max|Δh′| {dh} (scale {hs}), max|Δu| {du} (scale {us})")
    log(f"egcl tile vs simt (fast): max|Δh′| {dh:.3g} (rel {dh / hs:.3g}), max|Δu| {du:.3g} "
        f"(rel {du / us:.3g})")
    wh = p.head_width
    edge_ops = 2 * c * (c + 12) + 2 * c * wh + 2 * c * c + 2 * c + 12 * c
    center_ops = 2 * c * c + 2 * 2 * c * c + 2 * c * c
    ops = bsz * n * (k * edge_ops + center_ops)
    nbytes = 4 * bsz * n * (2 * c + 6 + k) + packed.simt.numel() * 4
    ms, plain, err = stats["fast tile"]
    eb, eby = bound_ms(nbytes, ops, PEAK_BF16)
    log(f"egcl bound: {ops / (bsz * n * k):.0f} FLOP/edge; fast vs bf16 peak {eb:.4f} ms, "
        f"accurate vs fp32 peak {bound_ms(nbytes, ops, PEAK_FP32)[0]:.4f} ms")

    m33 = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=1)
    p33 = egcl.params_from_layer(m33.to(dev).gcl_0)
    b33 = min(8, bsz)
    h33 = torch.randn(b33, n, 33, generator=gen).to(dev)
    x33, nbr33 = xs[:b33].contiguous(), nbr[:b33].contiguous()
    for accurate in (True, False):
        reset_egcl_counters(egcl)
        got = egcl.egcl_layer(h33, x33, nbr33, p33, accurate)
        check(egcl.egcl_layer.launches_by_variant == {"tile": 0, "simt": 1},
              f"egcl C=33 launched {egcl.egcl_layer.launches_by_variant}")
        ref = egcl.egcl_layer_plain(h33, x33, nbr33, p33, accurate)
        eh, eu, sh, su = egcl_errors(torch, got, ref, x33, accurate)
        log(f"egcl[C=33, 1 head, accurate={accurate}] B={b33}: max|Δh′| {eh:.3g} "
            f"(rel {eh / sh:.3g}), max|Δu| {eu:.3g} (rel {eu / su:.3g})")
    return dict(name="egcl_layer", route="cuda",
                source="se3_equi_graph_registration_tpu_torch/csrc/egcl_tile.cu",
                replaces="se3_equi_graph_registration_tpu/ops/pallas/egcl_kernel.py:116",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=eb, bound_by=eby, library_ms=None, variant="tile",
                simt_ms=stats["fast simt"][0], accurate_ms=stats["accurate"][0],
                simt_source="se3_equi_graph_registration_tpu_torch/csrc/egcl.cu")


def serve_phase(torch, dev, cfg, bsz, sd, rows):
    """The served path: Registrar.register and BatchingServer at `cfg`
    against the same Registrar on the CPU, with the launch counters; the
    engine's other configurations; pairs/s and two profiles."""
    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn

    n = cfg.num_nodes
    reg = serving.Registrar(sd, cfg, device=dev)
    cpu_reg = serving.Registrar(sd, cfg, device="cpu")
    reqs = make_pair_batch(np.random.default_rng(1), batch=bsz, n=n, feat_dim=cfg.in_node_nf)
    args = lambda sl: (reqs.src_pts[sl], reqs.src_feat[sl], reqs.tgt_pts[sl], reqs.tgt_feat[sl])

    def same(a, b, what, sim=True):
        """sim=False: a BatchingServer answer carries its coalesced batch's
        similarity mean, not its own."""
        Ra, ta, ia = a
        Rb, tb, ib = b
        dR = np.linalg.norm(np.asarray(Ra) - Rb, axis=(-2, -1)).max() / np.sqrt(2)
        dt = np.abs(np.asarray(ta) - tb).max()
        ca, cb = np.asarray(ia["pose_covariance"]), np.asarray(ib["pose_covariance"])
        dc = np.abs(ca - cb).max() / np.abs(cb).max()
        ds = (abs(ia["similarity_mean"] - ib["similarity_mean"])
              / abs(ib["similarity_mean"]) if sim else 0.0)
        check(np.all(np.isfinite(Ra)) and np.all(np.isfinite(ta)) and np.all(np.isfinite(ca)),
              f"{what}: non-finite output")
        check(np.abs(np.linalg.det(Ra) - 1).max() < 1e-3, f"{what}: det R != 1")
        check(dR <= 2e-3 and dt <= 2e-3 and dc <= 2e-2 and ds <= 2e-2,
              f"{what}: card vs CPU dR {dR} dt {dt} dcov {dc} dsim {ds}")
        return dR, dt

    knn.knn_window.launches = 0
    reset_egcl_counters(egcl)
    per_call = []

    def counted(fn):
        k0, e0 = knn.knn_window.launches, egcl.egcl_layer.launches
        out = fn()
        per_call.append((knn.knn_window.launches - k0, egcl.egcl_layer.launches - e0))
        return out

    t_serve = time.perf_counter()
    calls = [(f"B=1 #{i}", i) for i in range(3)] + [
        (f"B={b}", slice(0, b)) for b in (16, bsz)]
    results = [(name, sl, counted(lambda: reg.register(*args(sl))))
               for name, sl in calls]
    server = serving.BatchingServer(reg, max_batch=4, max_wait_ms=20)
    try:
        futs = [server.submit(*args(i)) for i in range(3)]
        served = [f.result(timeout=300) for f in futs]
    finally:
        server.close()
    check(not server._thread.is_alive(), "BatchingServer thread still running")
    rates = {}
    for b, reps in ((1, 20), (16, 10), (bsz, 5)):
        sl = slice(0, b) if b > 1 else 0
        reg.register(*args(sl))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            reg.register(*args(sl))
        rates[b] = b * reps / (time.perf_counter() - t1)
    launches = (knn.knn_window.launches, egcl.egcl_layer.launches)
    by_variant = dict(egcl.egcl_layer.launches_by_variant)
    log(f"serve: main path run {time.perf_counter() - t_serve:.1f} s, launches knn "
        f"{launches[0]} egcl {launches[1]} ({by_variant})")
    for kd, ed in per_call:
        check(kd == 2 and ed == 2 * cfg.n_layers,
              f"register() launched knn {kd}, egcl {ed} (want 2, {2 * cfg.n_layers})")
    check(launches[0] > 0 and launches[1] > 0, "a kernel of the path never launched")
    want = "simt" if cfg.egnn_accurate else "tile"
    check(by_variant[want] == launches[1] and sum(by_variant.values()) == launches[1],
          f"serve: EGCL launches by kernel {by_variant}, want all {launches[1]} {want}")
    record_launches(rows, "serve", dict(knn_window=launches[0], egcl_layer=launches[1]))

    other_configs(torch, dev, cfg, sd, args, same)

    for name, sl, res in results:
        t1 = time.perf_counter()
        dR, dt = same(res, cpu_reg.register(*args(sl)), f"register {name}")
        log(f"register {name}: card vs CPU max‖ΔR‖/√2 {dR:.3g}, max|Δt| {dt:.3g} m "
            f"(CPU run {time.perf_counter() - t1:.1f} s)")
    for i, res in enumerate(served):
        same(res, reg.register(*args(i)), f"BatchingServer request {i}", sim=False)
    log("BatchingServer: 3 concurrent submits answered, equal to register()")
    log("pairs/s (register(), host clock incl. H2D and result copy): "
        + ", ".join(f"B={b}: {r:.1f}" for b, r in rates.items()))
    profile_call(torch, lambda: reg.register(*args(0)), "register() B=1")
    profile_call(torch, lambda: reg.register(*args(slice(0, bsz))), f"register() B={bsz}")


def grad_cosines(torch, a, b):
    """{name: (cosine, relative L2)} of two gradient dicts."""
    out = {}
    for name, ga in a.items():
        x, y = ga.double().flatten(), b[name].double().flatten()
        cos = float(x @ y / (x.norm() * y.norm()).clamp_min(1e-300))
        out[name] = (cos, float((x - y).norm() / y.norm().clamp_min(1e-300)))
    return out


def train_phase(torch, dev, cfg, bsz, rows):
    """The training path at `cfg`: seeded weights and Adam, one warm step and
    5 timed steps at `bsz` with the launch counters; an accurate step at B=2
    on the card against the same step on the CPU; the fast-against-accurate
    gradient table at B=8; a profile of one warm step."""
    import dataclasses

    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
    from se3_equi_graph_registration_tpu_torch.train import engine

    rng = np.random.default_rng(2)
    batch = lambda b, dv: engine.batch_to_device(
        tuple(make_pair_batch(rng, batch=b, n=cfg.num_nodes, feat_dim=cfg.in_node_nf)), dv)
    state = engine.init_state(cfg, torch.Generator().manual_seed(0), device=dev)
    step = engine.make_train_step(state.model, state.optimizer, cfg)
    batches = [batch(bsz, dev) for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, batches[1])
    torch.cuda.synchronize()
    counters = (knn.knn_window, egcl.egcl_layer, eb.egcl_backward)
    for fn in counters:
        fn.launches = 0
    reset_egcl_counters(egcl)
    per_step, totals = [], []
    t0 = time.perf_counter()
    for i in range(5):
        before = [fn.launches for fn in counters]
        state, m = step(state, batches[i % 2])
        per_step.append([fn.launches - b0 for fn, b0 in zip(counters, before)])
        totals.append(m["total"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    losses = torch.stack(totals).cpu()
    L = cfg.n_layers
    check(bool(torch.all(torch.isfinite(losses))), f"train: non-finite loss {losses}")
    for counts in per_step:
        check(counts == [2, 2 * L, 2 * L],
              f"train step launched knn/egcl/egcl_backward {counts} (want 2, {2 * L}, {2 * L})")
    by_variant = dict(egcl.egcl_layer.launches_by_variant)
    want = "simt" if cfg.egnn_accurate else "tile"
    check(by_variant[want] == launches[1] and sum(by_variant.values()) == launches[1],
          f"train: EGCL launches by kernel {by_variant}, want all {launches[1]} {want}")
    record_launches(rows, "train", dict(zip(("knn_window", "egcl_layer", "egcl_backward"),
                                            launches)))
    log(f"train B={bsz}: 5 steps in {dt:.3f} s, {5 * bsz / dt:.1f} pairs/s (host clock, "
        f"synchronized at the end), losses {[round(float(v), 4) for v in losses]}; launches "
        f"knn {launches[0]} egcl {launches[1]} ({by_variant}) egcl_backward {launches[2]}; peak memory of "
        f"the 6 steps {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # --- the accurate step on the card against the same step on the CPU ---
    acfg = dataclasses.replace(cfg, egnn_accurate=True)
    cpu = engine.init_state(acfg, torch.Generator().manual_seed(1), device="cpu")
    card_model = engine.build_model(acfg, device=dev)
    card_model.load_state_dict(cpu.model.state_dict())
    card = engine.TrainState(card_model, engine.build_optimizer(card_model, acfg))
    small = batch(2, "cpu")
    small_card = {k: v.to(dev) for k, v in small.items()}

    def grads(model, b):
        model.zero_grad(set_to_none=True)
        lb = engine.train_loss(model, acfg, b)
        lb.total.backward()
        g = {n: q.grad.detach().float().cpu() for n, q in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(lb.total.detach()), g

    t1 = time.perf_counter()
    lc, gc = grads(cpu.model, small)
    lg, gg = grads(card.model, small_card)
    cos = grad_cosines(torch, gg, gc)
    for st, b in ((cpu, small), (card, small_card)):
        engine.make_train_step(st.model, st.optimizer, acfg)(st, b)
    cpu_sd = cpu.model.state_dict()
    dp, dp_big = {}, {}
    for n, q in card.model.named_parameters():
        d = (q.detach().cpu() - cpu_sd[n]).abs()
        big = gc[n].abs() > 1e-3 * gc[n].abs().max()
        dp[n], dp_big[n] = float(d.max()), float(d[big].max()) if bool(big.any()) else 0.0
    worst = min(cos, key=lambda k: cos[k][0])
    worst_l2 = max(cos, key=lambda k: cos[k][1])
    worst_p, worst_big = max(dp, key=dp.get), max(dp_big, key=dp_big.get)
    check(abs(lg - lc) <= 1e-4 * abs(lc), f"train card vs CPU: loss {lg} vs {lc}")
    check(cos[worst][0] >= 0.9999, f"train card vs CPU: gradient cosine {worst} {cos[worst]}")
    check(cos[worst_l2][1] <= 1e-4,
          f"train card vs CPU: gradient relative L2 {worst_l2} {cos[worst_l2]}")
    check(dp_big[worst_big] <= 1e-6,
          f"train card vs CPU: post-Adam |Δ| where |g| is above the noise floor, "
          f"{worst_big} {dp_big[worst_big]}")
    check(dp[worst_p] <= 2 * acfg.lr, f"train card vs CPU: post-Adam |Δ| {worst_p} {dp[worst_p]}")
    log(f"train accurate B=2 card vs CPU: loss {lg:.6f} vs {lc:.6f} (rel {abs(lg - lc) / abs(lc):.2g}); "
        f"worst gradient cosine {worst} {cos[worst][0]:.6f}, worst relative L2 {worst_l2} "
        f"{cos[worst_l2][1]:.2g}; post-Adam max|Δ| {worst_big} {dp_big[worst_big]:.3g} where "
        f"|g| > 1e-3 of its max, {worst_p} {dp[worst_p]:.3g} everywhere (lr {acfg.lr}); CPU side "
        f"{time.perf_counter() - t1:.1f} s")

    # --- fast against accurate on the card, same weights and batch ---
    mid = batch(8, dev)
    fcfg = dataclasses.replace(acfg, egnn_accurate=False)
    _, ga = grads(card.model, mid)
    card.model.zero_grad(set_to_none=True)
    lb = engine.train_loss(card.model, fcfg, mid)
    lb.total.backward()
    gf = {n: q.grad.detach().float().cpu() for n, q in card.model.named_parameters()}
    card.model.zero_grad(set_to_none=True)
    check(all(bool(torch.all(torch.isfinite(g))) for g in gf.values()), "fast gradients not finite")
    table = sorted(grad_cosines(torch, gf, ga).items(), key=lambda kv: kv[1][0])
    rels = sorted(r for _, (_, r) in table)
    log(f"train fast vs accurate gradients B=8 (card, {len(table)} tensors), worst first; "
        f"median rel L2 {rels[len(rels) // 2]:.3g}:")
    for name, (c, r) in table[:6]:
        log(f"  | {name} | {c:.4f} | {r:.3g} |")

    profile_call(torch, lambda: step(state, batches[0]), f"train step B={bsz}")


def bumpy_surface(seed=0):
    """The Gaussian-bump height field of tests/test_global_registration.py
    (locally distinctive geometry): surf(rng, n) samples n points of it with
    2 mm noise."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.6, 1.6, (30, 2))
    amps = rng.uniform(-0.35, 0.35, 30)
    widths = rng.uniform(0.08, 0.3, 30)

    def surf(rng2, n):
        xy = np.stack([rng2.uniform(-1, 1, n), rng2.uniform(-1, 1, n)], -1)
        z = np.zeros(n)
        for (cx, cy), a, w in zip(centers, amps, widths):
            z += a * np.exp(-((xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2) / w)
        pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
        return pts + rng2.standard_normal(pts.shape).astype(np.float32) * 0.002

    return surf


def pose_err(Rh, th, R, t):
    """(rotation error in degrees, max |Δt|) of an estimate against the truth."""
    return (float(np.degrees(np.linalg.norm(Rh - R) / np.sqrt(2))),
            float(np.abs(th - t).max()))


def surface_pairs(count, seed):
    """`count` (src, tgt, R, t): the bumpy surface sampled twice
    independently at FPFH_N points, tgt under a random pose."""
    from se3_equi_graph_registration_tpu_torch.data.synthetic import random_rotation

    surf, rng = bumpy_surface(), np.random.default_rng(seed)
    out = []
    for _ in range(count):
        src = surf(rng, FPFH_N)
        R = random_rotation(rng).astype(np.float32)
        t = (rng.standard_normal(3) * 0.3).astype(np.float32)
        out.append((src, (surf(rng, FPFH_N) @ R.T + t).astype(np.float32), R, t))
    return out


def spfh_bin_flips(spfh, ref, dist_ref):
    """(edge-channel entries in another bin, max|ΔSPFH| over centers whose
    counts all agree): counts come back from rows scaled to 100."""
    valid = (dist_ref > 0).sum(-1, keepdim=True).double()
    cg = (spfh.double() * valid / 100.0).round()
    cr = (ref.double() * valid / 100.0).round()
    dc = (cg - cr).abs()
    same = dc.sum(-1) == 0
    return float(dc.sum() / 2), float((spfh - ref).abs()[same].max())


def fpfh_kernel_phase(torch, dev, bsz):
    """B4 and B5 against their plain versions, and B1 at the pipeline's
    k=60/W=768, on `bsz` curve-sorted surface clouds at full width. Returns
    the B4 and B5 rows."""
    from se3_equi_graph_registration_tpu_torch.ops import fpfh, morton
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn, spfh

    n, k, tile, w = FPFH_N, FPFH_K, FPFH_TILE, FPFH_WINDOW
    x = torch.from_numpy(np.stack([p[0] @ p[2].T for p in surface_pairs(bsz, 100)])).to(dev)
    _, xs, _ = morton.sort_by_curve(x[..., :0], x)
    xs = xs.contiguous()

    got = knn.knn_chunked(xs, k, tile, w)
    torch.cuda.synchronize()
    ref = knn.knn_chunked_plain(xs, k, tile, w)
    check(torch.equal(got, ref), "knn_chunked: the kernel's lists differ from its plain version")
    packed = knn.knn_window(xs, k, tile, w, packed=True)
    same_sets = torch.all(torch.sort(got, -1).values == torch.sort(packed, -1).values, -1)
    ms4 = cuda_ms(torch, lambda: knn.knn_chunked(xs, k, tile, w), 20)
    plain4 = cuda_ms(torch, lambda: knn.knn_chunked_plain(xs, k, tile, w), 3)
    b4, b4by = bound_ms(xs.numel() * 4 + bsz * n * k * 4, bsz * n * w * 8, PEAK_FP32)
    log(f"knn_chunked B={bsz} N={n} k={k} T={tile} W={w} (C={w // 128}, S_pc="
        f"{min(2 * -(-k // (w // 128)), 128 // (w // 128))}): identical to the plain version; "
        f"neighbor sets equal to B1 packed on {float(same_sets.float().mean()):.6f} of rows; "
        f"kernel {ms4:.4f} ms, plain {plain4:.3f} ms, bound {b4:.4f} ms ({b4by})")
    for mode in ("packed", "exact"):
        kw = dict(tile=tile, window=w, packed=mode == "packed")
        g1 = knn.knn_window(xs, k, **kw)
        torch.cuda.synchronize()
        n_bad, err = knn_compare(xs, knn.knn_window_plain(xs, k, **kw), g1)
        ms1 = cuda_ms(torch, lambda: knn.knn_window(xs, k, **kw), 20)
        log(f"knn[{mode}] at the pipeline's shape B={bsz} N={n} k={k} W={w}: rows differing "
            f"{n_bad} (near-ties), max|Δd²| {err:.3g}, kernel {ms1:.4f} ms")

    normals = fpfh.estimate_normals_window(xs, got[..., :FPFH_KN]).contiguous()
    edges = bsz * n * k
    stats = {}
    for accurate in (True, False):
        name = "accurate" if accurate else "fast"
        sg, dg = spfh.spfh(xs, normals, got, tile, w, accurate)
        torch.cuda.synchronize()
        sr, dr = spfh.spfh_plain(xs, normals, got, tile, w, accurate)
        derr = float(((dg - dr).abs() / dr.abs().clamp_min(1e-30)).max())
        flips, serr = spfh_bin_flips(sg, sr, dr)
        check(torch.isfinite(sg).all() and derr <= 1e-6 and flips <= 1e-4 * edges
              and serr <= 1e-3,
              f"spfh {name}: dist rel {derr}, {flips} edge-channels in another bin, "
              f"max|ΔSPFH| {serr} where the counts agree")
        ms5 = cuda_ms(torch, lambda: spfh.spfh(xs, normals, got, tile, w, accurate), 20)
        plain5 = cuda_ms(torch, lambda: spfh.spfh_plain(xs, normals, got, tile, w, accurate), 3)
        stats[name] = (ms5, plain5, serr)
        log(f"spfh[{name}] B={bsz} N={n} K={k} W={w}: dist max rel {derr:.3g}, "
            f"{flips:.0f} of {edges} edge-channels in another bin, max|ΔSPFH| {serr:.3g} "
            f"where the counts agree (of 100 per channel); kernel {ms5:.4f} ms, plain "
            f"{plain5:.3f} ms")
    nbytes5 = xs.numel() * 4 * 2 + edges * 4 * 2 + bsz * n * 33 * 4
    b5, b5by = bound_ms(nbytes5, edges * SPFH_EDGE_OPS, PEAK_FP32)
    log(f"spfh bound: {SPFH_EDGE_OPS} fp32 operations per edge, {nbytes5 / 1e6:.1f} MB: "
        f"{b5:.4f} ms ({b5by})")
    tf32_check(torch, xs, got)
    ms5, plain5, serr = stats["accurate"]
    return [dict(name="knn_chunked", route="cuda",
                 source="se3_equi_graph_registration_tpu_torch/csrc/knn_chunked.cu",
                 replaces="se3_equi_graph_registration_tpu/ops/pallas/knn_kernel.py:93",
                 launches=0, max_abs_err=0.0, ms=ms4, plain_ms=plain4, bound_ms=b4,
                 bound_by=b4by, library_ms=None),
            dict(name="spfh", route="cuda",
                 source="se3_equi_graph_registration_tpu_torch/csrc/spfh.cu",
                 replaces="se3_equi_graph_registration_tpu/ops/pallas/spfh_kernel.py:62",
                 launches=0, max_abs_err=serr, ms=ms5, plain_ms=plain5, bound_ms=b5,
                 bound_by=b5by, library_ms=None)]


def tf32_check(torch, xs, nbr):
    """With TF32 enabled for matmuls, the normals' moments and the branch
    verification equal their TF32-off values (they use no matmul); a
    matmul-based verification, printed for contrast, does not."""
    from se3_equi_graph_registration_tpu_torch.core.se3 import matrix_exp_so3
    from se3_equi_graph_registration_tpu_torch.ops import fpfh
    from se3_equi_graph_registration_tpu_torch.ops.knn import pairwise_sq_dists
    from se3_equi_graph_registration_tpu_torch.registration import _branch_verify_ms

    b = min(8, xs.shape[0])
    x, nb = xs[:b], nbr[:b, :, :FPFH_KN].contiguous()
    n_keep = int(0.35 * x.shape[1])
    g = torch.Generator().manual_seed(3)
    R = matrix_exp_so3((torch.randn(b, 4, 3, generator=g) * 1e-3).to(x.device))
    t = (torch.randn(b, 4, 3, generator=g) * 1e-3).to(x.device)
    tgt = (x + 1e-3 * torch.randn(x.shape, generator=g).to(x.device)).flip(-2).contiguous()

    def matmul_verify():
        posed = torch.einsum("bkij,bnj->bkni", R, x) + t[..., None, :]
        d2 = pairwise_sq_dists(posed, tgt[:, None])
        return torch.mean(torch.topk(d2.amin(-1), n_keep, dim=-1, largest=False).values, -1)

    prev = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            out[tf32] = (fpfh.estimate_normals_window(x, nb), _branch_verify_ms(R, t, x, tgt, n_keep),
                         matmul_verify())
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    dn = float((out[True][0] - out[False][0]).abs().max())
    dv = float(((out[True][1] - out[False][1]).abs() / out[False][1].abs()).max())
    dm = float(((out[True][2] - out[False][2]).abs() / out[False][2].abs()).max())
    check(dn <= 1e-6 and dv <= 1e-6, f"TF32 reached fp32-pinned work: normals {dn}, verify {dv}")
    log(f"TF32 on: normals max|Δ| {dn:.3g}, branch verify rel {dv:.3g} (fp32-pinned); a "
        f"matmul-based verify moves by rel {dm:.3g} (the hazard the pin removes)")


def register_fpfh_phase(torch, dev, rows):
    """The checkpoint-free path at full width (fused, chunked, W=768,
    N=2048): register_fpfh on the card against the same call on the CPU, at
    4 branches and 1, with the launch counters; pairs/s at b=1 and of
    register_fpfh_batch at B=8 and 32; a profile of one b=1 call."""
    from se3_equi_graph_registration_tpu_torch import registration
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn, spfh
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    kw = dict(knn_method="fused", knn_packed="chunked", window=FPFH_WINDOW)
    (src, tgt, R, t), = surface_pairs(1, 6)
    counters = dict(knn_window=knn.knn_window, egcl_layer=egcl.egcl_layer,
                    egcl_backward=eb.egcl_backward, knn_chunked=knn.knn_chunked, spfh=spfh.spfh)
    for fn in counters.values():
        fn.launches = 0

    rates = {}
    t0 = time.perf_counter()
    for br in (4, 1):
        before = {k_: fn.launches for k_, fn in counters.items()}
        Rc, tc, ic = registration.register_fpfh(src, tgt, ransac_branches=br, **kw)
        torch.cuda.synchronize()
        d = {k_: fn.launches - before[k_] for k_, fn in counters.items()}
        check(d == dict(knn_window=0, egcl_layer=0, egcl_backward=0, knn_chunked=2, spfh=2),
              f"register_fpfh launched {d} (want knn_chunked 2, spfh 2, nothing else)")
        t1 = time.perf_counter()
        Rp, tp, ip = registration.register_fpfh(src, tgt, ransac_branches=br, device="cpu", **kw)
        cpu_s = time.perf_counter() - t1
        dR = float(np.linalg.norm(Rc - Rp) / np.sqrt(2))
        dt = float(np.abs(tc - tp).max())
        (ec, etc), (ep, etp) = pose_err(Rc, tc, R, t), pose_err(Rp, tp, R, t)
        check(all(np.isfinite(a).all() for a in (Rc, tc, ic["weights"], ic["pose_covariance"])),
              f"register_fpfh branches={br}: non-finite output")
        check(ec < 0.5 and etc < 5e-3 and ep < 0.5 and etp < 5e-3,
              f"register_fpfh branches={br}: ground truth missed, card {ec} deg {etc} m, "
              f"CPU {ep} deg {etp} m")
        check(dR <= 2e-3 and dt <= 2e-3, f"register_fpfh branches={br}: card vs CPU dR {dR} dt {dt}")
        log(f"register_fpfh branches={br} N={FPFH_N} fused/chunked W={FPFH_WINDOW}: launches {d}; "
            f"ground truth card {ec:.4f} deg {etc * 1e3:.3f} mm, CPU {ep:.4f} deg "
            f"{etp * 1e3:.3f} mm; card vs CPU ‖ΔR‖/√2 {dR:.3g}, |Δt| {dt:.3g} m "
            f"(CPU run {cpu_s:.1f} s)")
        reps = 10
        t1 = time.perf_counter()
        for _ in range(reps):
            registration.register_fpfh(src, tgt, ransac_branches=br, **kw)
        rates[f"b=1, {br} branches"] = reps / (time.perf_counter() - t1)
    for b in FPFH_BATCHES:
        pairs = surface_pairs(b, 200 + b)
        bs = np.stack([p[0] for p in pairs])
        bt = np.stack([p[1] for p in pairs])
        before = {k_: fn.launches for k_, fn in counters.items()}
        Rb, tb, _ = registration.register_fpfh_batch(bs, bt, seed=1, **kw)
        torch.cuda.synchronize()
        d = {k_: fn.launches - before[k_] for k_, fn in counters.items()}
        check(d["knn_chunked"] == 2 and d["spfh"] == 2 and d["knn_window"] == 0,
              f"register_fpfh_batch B={b} launched {d}")
        ok = sum(e[0] < 0.5 and e[1] < 5e-3
                 for e in (pose_err(Rb[i], tb[i], *pairs[i][2:]) for i in range(b)))
        check(np.isfinite(Rb).all() and ok >= b - 1,
              f"register_fpfh_batch B={b}: {ok} of {b} pairs recovered")
        torch.cuda.reset_peak_memory_stats()
        reps = 3
        t1 = time.perf_counter()
        for _ in range(reps):
            registration.register_fpfh_batch(bs, bt, seed=1, **kw)
        rates[f"batch B={b}"] = b * reps / (time.perf_counter() - t1)
        log(f"register_fpfh_batch B={b}: {ok}/{b} pairs within 0.5 deg / 5 mm; launches {d}; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = {k_: fn.launches for k_, fn in counters.items()}
    log(f"register_fpfh path: run {time.perf_counter() - t0:.1f} s, launches {launches}")
    log("register_fpfh pairs/s (host clock incl. sampling, H2D, noise draw and result copy; "
        "robust = 4 branches): " + ", ".join(f"{k_}: {r:.2f}" for k_, r in rates.items()))
    for name in ("knn_chunked", "spfh"):
        check(launches[name] > 0, f"{name} never launched on the register_fpfh path")
    record_launches(rows, "register_fpfh", launches)
    profile_call(torch, lambda: registration.register_fpfh(src, tgt, **kw), "register_fpfh b=1")


def other_configs(torch, dev, cfg, sd, args, same):
    """Every other configuration the engine accepts launches both kernels
    on the card and matches the CPU: the whole-cloud graph ('exact' and
    'approx', fp32 EGCL, SVD Kabsch) and the Morton-curve window with exact
    keys. Two pairs each, counters reset per configuration."""
    import dataclasses

    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
    from se3_equi_graph_registration_tpu_torch.train import engine

    base = dataclasses.asdict(cfg)
    variants = {
        "exact": dict(knn_method="exact", knn_packed=False, egnn_impl="xla",
                      egnn_accurate=True, kabsch_solver="svd"),
        "approx": dict(knn_method="approx", knn_packed=False, egnn_accurate=False),
        "morton window, exact keys": dict(knn_packed=False, curve="morton",
                                          egnn_accurate=True),
    }
    for name, kw in variants.items():
        vcfg = engine.EngineConfig(**dict(base, **kw))
        reg = serving.Registrar(sd, vcfg, device=dev)
        knn.knn_window.launches = 0
        reset_egcl_counters(egcl)
        res = reg.register(*args(slice(0, 2)))
        kd, ed = knn.knn_window.launches, egcl.egcl_layer.launches
        by_variant = dict(egcl.egcl_layer.launches_by_variant)
        check(kd == 2 and ed == 2 * vcfg.n_layers,
              f"config {name}: register() launched knn {kd}, egcl {ed}")
        check(by_variant["simt" if vcfg.egnn_accurate else "tile"] == ed,
              f"config {name}: EGCL launches by kernel {by_variant}")
        dR, dt = same(res, serving.Registrar(sd, vcfg, device="cpu").register(
            *args(slice(0, 2))), f"config {name}")
        log(f"config {name}: launches knn {kd} egcl {ed} ({by_variant}); card vs CPU "
            f"max‖ΔR‖/√2 {dR:.3g}, max|Δt| {dt:.3g} m")


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds both CUDA kernels from `se3_equi_graph_registration_tpu_torch/csrc`
(one nvcc per source, in parallel), holds each kernel against its plain
PyTorch version on the card at the served shapes, then drives the serving
path — `Registrar.register` and `BatchingServer` at the full
`fast_tpu_config` (N=2048, k=16, C=32, 3 layers, 4 heads, top_k=128) with
seeded random weights — and checks it against the same Registrar on the
CPU and against the launch counters. Any failed check raises (non-zero
exit, no result line). The last line is one JSON object with the device.

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


def profile_register(torch, call, bsz):
    """Device time by kernel over one warm register() under torch.profiler,
    and the device-busy share of that call's wall time (profiler on)."""
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
    log(f"profile register() B={bsz}: wall {wall_ms:.2f} ms (profiler on), device "
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


def main() -> int:
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

    rows = run(torch, dev, engine.fast_tpu_config(), bsz=64)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def run(torch, dev, cfg, bsz):
    """The three phases at `cfg` with `bsz` pairs; returns the kernel rows."""
    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops import morton
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
    from se3_equi_graph_registration_tpu_torch.train import checkpoints, engine

    n, k, c, tile, window = cfg.num_nodes, cfg.k, cfg.hidden_nf, cfg.egnn_tile, cfg.egnn_window
    rng = np.random.default_rng(0)
    pb = make_pair_batch(rng, batch=bsz, n=n, feat_dim=cfg.in_node_nf)
    x = torch.from_numpy(pb.src_pts).to(dev)
    _, xs, _ = morton.sort_by_curve(torch.zeros(bsz, n, 1, device=dev), x)
    xs = xs.contiguous()
    rows = []

    # --- phase 1: knn kernel vs plain, packed (served) then exact ---------
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
    rows.append(dict(name="knn_window", route="cuda",
                     source="se3_equi_graph_registration_tpu_torch/csrc/knn.cu",
                     replaces="se3_equi_graph_registration_tpu/ops/pallas/knn_kernel.py:26",
                     launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                     bound_ms=kb, bound_by=kby, library_ms=None))

    # --- phase 2: egcl kernel vs plain, both modes; C=33 one head --------
    gen = torch.Generator().manual_seed(0)
    cpu_model = engine.build_model(cfg, "eval_fusion", device="cpu")
    checkpoints.init_weights(cpu_model, gen)
    sd = cpu_model.state_dict()
    layer_model = engine.build_model(cfg, "eval_fusion", device=dev)
    layer_model.load_state_dict(sd)
    p = egcl.params_from_layer(layer_model.egnn.gcl_0)
    packed = egcl.pack_params(p)
    h = torch.randn(bsz, n, c, generator=gen).to(dev)
    nbr = knn.knn_window(xs, k, tile=tile, window=window, packed=True)
    egcl_stats = {}
    for accurate in (True, False):
        name = "accurate" if accurate else "fast"
        gh, gx = egcl.egcl_layer(h, xs, nbr, p, accurate, packed)
        torch.cuda.synchronize()
        ref = egcl.egcl_layer_plain(h, xs, nbr, p, accurate)
        eh, eu, sh, su = egcl_errors(torch, (gh, gx), ref, xs, accurate)
        ms = cuda_ms(torch, lambda: egcl.egcl_layer(h, xs, nbr, p, accurate, packed), 10)
        plain = cuda_ms(torch, lambda: egcl.egcl_layer_plain(h, xs, nbr, p, accurate), 3)
        egcl_stats[name] = (ms, plain, max(eh, eu))
        log(f"egcl[{name}] B={bsz} N={n} C={c} K={k}: max|Δh′| {eh:.3g} (rel {eh / sh:.3g}), "
            f"max|Δu| {eu:.3g} (rel {eu / su:.3g} of the update scale {su:.3g}), "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
    wh = p.head_width
    edge_ops = 2 * c * (c + 12) + 2 * c * wh + 2 * c * c + 2 * c + 12 * c
    center_ops = 2 * c * c + 2 * 2 * c * c + 2 * c * c
    ops = bsz * n * (k * edge_ops + center_ops)
    nbytes = 4 * bsz * n * (2 * c + 6 + k) + packed.numel() * 4
    ms, plain, err = egcl_stats["fast"]
    eb, eby = bound_ms(nbytes, ops, PEAK_BF16)
    log(f"egcl bound: {ops / (bsz * n * k):.0f} FLOP/edge; fast vs bf16 peak {eb:.4f} ms, "
        f"accurate vs fp32 peak {bound_ms(nbytes, ops, PEAK_FP32)[0]:.4f} ms")
    rows.append(dict(name="egcl_layer", route="cuda",
                     source="se3_equi_graph_registration_tpu_torch/csrc/egcl.cu",
                     replaces="se3_equi_graph_registration_tpu/ops/pallas/egcl_kernel.py:116",
                     launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                     bound_ms=eb, bound_by=eby, library_ms=None))

    m33 = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=1)
    p33 = egcl.params_from_layer(m33.to(dev).gcl_0)
    b33 = min(8, bsz)
    h33 = torch.randn(b33, n, 33, generator=gen).to(dev)
    x33, nbr33 = xs[:b33].contiguous(), nbr[:b33].contiguous()
    for accurate in (True, False):
        got = egcl.egcl_layer(h33, x33, nbr33, p33, accurate)
        ref = egcl.egcl_layer_plain(h33, x33, nbr33, p33, accurate)
        eh, eu, sh, su = egcl_errors(torch, got, ref, x33, accurate)
        log(f"egcl[C=33, 1 head, accurate={accurate}] B={b33}: max|Δh′| {eh:.3g} "
            f"(rel {eh / sh:.3g}), max|Δu| {eu:.3g} (rel {eu / su:.3g})")

    # --- phase 3: the served path ----------------------------------------
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
    egcl.egcl_layer.launches = 0
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
    log(f"serve: main path run {time.perf_counter() - t_serve:.1f} s, launches knn "
        f"{launches[0]} egcl {launches[1]}")
    for kd, ed in per_call:
        check(kd == 2 and ed == 2 * cfg.n_layers,
              f"register() launched knn {kd}, egcl {ed} (want 2, {2 * cfg.n_layers})")
    check(launches[0] > 0 and launches[1] > 0, "a kernel of the path never launched")
    rows[0]["launches"], rows[1]["launches"] = launches

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
    profile_register(torch, lambda: reg.register(*args(0)), 1)
    profile_register(torch, lambda: reg.register(*args(slice(0, bsz))), bsz)
    return rows


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
        knn.knn_window.launches = egcl.egcl_layer.launches = 0
        res = reg.register(*args(slice(0, 2)))
        kd, ed = knn.knn_window.launches, egcl.egcl_layer.launches
        check(kd == 2 and ed == 2 * vcfg.n_layers,
              f"config {name}: register() launched knn {kd}, egcl {ed}")
        dR, dt = same(res, serving.Registrar(sd, vcfg, device="cpu").register(
            *args(slice(0, 2))), f"config {name}")
        log(f"config {name}: launches knn {kd} egcl {ed}; card vs CPU "
            f"max‖ΔR‖/√2 {dR:.3g}, max|Δt| {dt:.3g} m")


if __name__ == "__main__":
    sys.exit(main())

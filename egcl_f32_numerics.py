#!/usr/bin/env python3
"""Where the kitti preset's train-step gradients on one NVIDIA GPU part
from the same step on the CPU, for each variant of the accurate-mode EGCL
kernels at C=33 (one head), and why.

    python3 egcl_f32_numerics.py [--trainings 6]

Writes a kitti dataset root as `chip_smoke.py`'s cli phase does
(`write_cli_root`, seed 5) and trains one epoch with `cli train` on the
card `--trainings` times, on the fp32 tile and the SIMT kernels in turn
(the kernels' atomic sums change order from run to run, so the trained
weights differ in their last bits). At each epoch's weights it takes the
first train batch's loss gradient with `engine.remat=true` on the card and
without it on the CPU (the plain versions), as that phase's gate does
(every tensor's cosine ≥ 0.9999 and relative L2 ≤ 1e-4), on the card once
with each EGCL kernel variant: the fp32 tile kernels as built ('tile_f32'),
the same sources with the SiLU on the IEEE exponential and division
('tile_f32, exact SiLU', compiled beside the package's own build from an
edited copy of `csrc/egcl_tile_f32.cuh`), and the SIMT kernels ('simt').
Then, on the CPU, it finds the pre-activation of the head's score MLP
(`mlp.dense_0`, `mlp.dense_1`, before their ReLUs) nearest to 0 and
flips its sign, a change below a float32 rounding of the inputs that turns
its ReLU on or off, and prints how far that moves each gradient. Last, the
B2 (with agg_m) and B3 time of each variant at the step's shape (B=8,
N=2048, K=16; CUDA events), the card's name and power limit, and one JSON
line. Runs with torch's default TF32 flags (matmul off, cuDNN on), as the
cli phase does.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

HEADER = "egcl_tile_f32.cuh"
SOURCES = ("egcl_tile_f32", "egcl_backward_tile_f32")
EXACT_SILU = [
    ("__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }",
     "__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }"),
    ("const float s = __fdividef(1.0f, 1.0f + __expf(-v));",
     "const float s = 1.0f / (1.0f + expf(-v));")]
SCORE_LAYERS = ("mlp.dense_0", "mlp.dense_1")


def build_variant(build, tmp, edits):
    """The fp32 tile libraries built from a copy of csrc/ with `edits` made
    to the shared header: {source name: loaded library}."""
    csrc = os.path.join(tmp, "csrc")
    shutil.copytree(build.CSRC, csrc)
    path = os.path.join(csrc, HEADER)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{old!r} is not in {HEADER}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    libs = {}
    for name in SOURCES:
        out = os.path.join(tmp, f"lib{name}.so")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", out,
                        os.path.join(csrc, f"{name}.cu")], check=True, capture_output=True)
        libs[name] = ctypes.CDLL(out)
    return libs


def cpu_gradients(torch, engine, ecfg, sd, batch, flip=None):
    """The CPU's loss gradient at sd, with the pre-activation of the score
    MLP layer `flip` nearest to 0 negated (its ReLU on the other branch, the
    gradient still flowing through it); returns (gradients, {layer: (flat
    index, value) of that pre-activation})."""
    model = engine.build_model(ecfg, device="cpu")
    model.load_state_dict(sd)
    nearest = {}

    def hook(out, name):
        idx = int(torch.argmin(out.detach().abs().reshape(-1)))
        nearest[name] = (idx, float(out.detach().reshape(-1)[idx]))
        if name != flip:
            return None
        other = torch.zeros_like(out, dtype=torch.bool)
        other.view(-1)[idx] = True            # the value negated, the gradient through it kept
        return out + torch.where(other, (-2 * out).detach(), torch.zeros_like(out))

    for name, module in model.named_modules():
        if name.endswith(SCORE_LAYERS):
            short = name[name.index("mlp."):]
            module.register_forward_hook(lambda m, i, o, short=short: hook(o, short))
    engine.train_loss(model, ecfg, engine.batch_to_device(batch, "cpu")).total.backward()
    return {m: q.grad for m, q in model.named_parameters()}, nearest


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trainings", type=int, default=6,
                    help="epochs trained, on the two kernels in turn")
    trainings = ap.parse_args(argv).trainings
    if not torch.cuda.is_available():
        print("egcl_f32_numerics: no CUDA device")
        return 2
    import chip_smoke
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build, egcl, knn
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
    from se3_equi_graph_registration_tpu_torch.train import cli, config, engine

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    build.build_all()
    load, check_variant = build.load, egcl.check_variant
    gates, flips, times = [], [], {}
    with tempfile.TemporaryDirectory() as tmp:
        variants = {"tile_f32": None,
                    "tile_f32, exact SiLU": build_variant(build, tmp, EXACT_SILU),
                    "simt": None}

        def use(name):
            libs = variants[name]
            build.load = load if libs is None else (
                lambda nm, libs=libs: libs.get(nm) or load(nm))
            egcl.check_variant = check_variant if name != "simt" else (
                lambda variant, c, k, hw, accurate: "simt")

        base = os.path.join(tmp, "kitti")
        chip_smoke.write_cli_root(torch, os.path.join(base, "data"), "kitti", 33, seed=5)
        try:
            for t in range(trainings):
                trained_on = ("tile_f32", "simt")[t % 2]
                use(trained_on)
                common = ["--preset", "kitti", "--set", f"data.root={base}/data",
                          "data.legacy_sampling_rng=true", f"run.checkpoint_dir={base}/ckpt{t}",
                          f"run.log_path={base}/log{t}.jsonl", "run.epochs=1"]
                cfg, _ = config.parse_cli(common)
                state, _ = chip_smoke.quiet_cli(cli, ["train", *common])
                sd = {q: v.detach().cpu() for q, v in state.model.state_dict().items()}
                batch = next(iter(cli._loader(cfg, "train", shuffle=False)()))
                ref, nearest = cpu_gradients(torch, engine, cfg.engine, sd, batch)
                rcfg, _ = config.parse_cli(common + ["--set", "engine.remat=true"])
                row = dict(training=t, trained_on=trained_on)
                for name in variants:
                    use(name)
                    model = engine.build_model(rcfg.engine, device=dev)
                    model.load_state_dict(sd)
                    engine.train_loss(model, rcfg.engine,
                                      engine.batch_to_device(batch, dev)).total.backward()
                    cos = chip_smoke.grad_cosines(
                        torch, {m: q.grad.cpu() for m, q in model.named_parameters()}, ref)
                    worst = max(cos, key=lambda m: cos[m][1])
                    row[name] = dict(worst_relative_l2=[worst, cos[worst][1]],
                                     worst_cosine=min(v[0] for v in cos.values()),
                                     gate=all(v[0] >= 0.9999 and v[1] <= 1e-4
                                              for v in cos.values()))
                gates.append(row)
                print(f"training {t} on {trained_on}: " + "; ".join(
                    f"{name} worst relative L2 {row[name]['worst_relative_l2'][0]} "
                    f"{row[name]['worst_relative_l2'][1]:.3g} (gate "
                    f"{'held' if row[name]['gate'] else 'failed'})" for name in variants),
                    flush=True)
                for layer in SCORE_LAYERS:
                    flipped, _ = cpu_gradients(torch, engine, cfg.engine, sd, batch, layer)
                    rel = {m: float((flipped[m] - ref[m]).norm() / ref[m].norm()) for m in ref}
                    worst = max(rel, key=rel.get)
                    flips.append(dict(training=t, layer=layer, index=nearest[layer][0],
                                      value=nearest[layer][1], worst=[worst, rel[worst]]))
                    print(f"  CPU: {layer} pre-activation nearest 0 at flat index "
                          f"{nearest[layer][0]}: {nearest[layer][1]:.3g}; its sign flipped "
                          f"moves {worst} by {rel[worst]:.3g} (relative L2)", flush=True)

            gen = torch.Generator().manual_seed(0)
            layer = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=1)
            p = egcl.params_from_layer(layer.to(dev).gcl_0)
            b, n, k = 8, 2048, 16
            x = (torch.rand(b, n, 3, generator=gen) * 3 - 1.5).to(dev)
            h = torch.randn(b, n, 33, generator=gen).to(dev)
            nbr = knn.knn_window(x, k, tile=128, window=None, packed=False)
            dm = torch.randn(b, n, 33, generator=gen).to(dev)
            dx = torch.randn(b, n, 3, generator=gen).to(dev)
            packed = egcl.pack_for_kernels(p)
            for name in variants:
                use(name)
                kv = "simt" if name == "simt" else "tile_f32"
                times[name] = dict(
                    b2_ms=chip_smoke.cuda_ms(torch, lambda: egcl.egcl_layer(
                        h, x, nbr, p, True, packed, return_aggm=True, variant=kv), 10),
                    b3_ms=chip_smoke.cuda_ms(torch, lambda: eb.egcl_backward(
                        h, x, nbr, p, dm, dx, True, packed, kv), 5))
                print(f"{name}: B2 {times[name]['b2_ms']:.4f} ms, B3 {times[name]['b3_ms']:.4f} "
                      f"ms at B={b}, N={n}, C=33, K={k}", flush=True)
        finally:
            build.load, egcl.check_variant = load, check_variant
    print(chip_smoke.card_line())
    print(json.dumps({"kitti_step_gradients_card_vs_cpu": gates, "score_mlp_flips": flips,
                      "kernel_ms": times, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

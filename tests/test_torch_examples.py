"""The port's example twins (`se3_equi_graph_registration_tpu_torch/examples`)
against the JAX package's scripts, on the CPU at small sizes.

- register_pair: both scripts on one `.pth` written by the JAX exporter and
  the same synthetic pair, with --parity (exact k-NN, SVD Kabsch, fp32):
  R and t within 1e-4, the gate tests/test_torch_serving.py holds
  `register()` to; the port's other modes run (fast seeded init, --robust,
  --pkl);
- denoise: 8 steps, accumulate 4 (two Adam updates), from the weights of
  JAX's `model.init(PRNGKey(0), ...)`: every step's MSE within 1e-4
  relative of the MSEs the JAX script computes (and prints, rounded);
- global_registration at --n-points 512: under 1 deg (the JAX test's gate);
- multihost_train --demo: both gloo ranks finish with equal losses, equal
  within 1e-5 relative to a one-process fit over the same 16 pairs;
- each twin, called with no card and no `--device cpu`, raises.
"""
import contextlib
import io
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu_torch.examples import (denoise, global_registration,
                                                            multihost_train, register_pair)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one torch thread, so that the lane's parallel workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_jax_script(name, argv, monkeypatch):
    """Run examples/<name>.py in this process as its command line does;
    its standard output."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(ROOT, "examples", name), run_name="__main__")
    return buf.getvalue()


def _quiet(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def test_register_pair_parity_matches_the_jax_script(tmp_path, monkeypatch):
    from torch_port_util import jax_model_params

    from se3_equi_graph_registration_tpu import serving as jserving
    from se3_equi_graph_registration_tpu.train import checkpoints as jckpt
    from se3_equi_graph_registration_tpu.train import engine as jengine

    _, params = jax_model_params(jengine.EngineConfig(num_nodes=128), "eval_fusion")
    pth = str(tmp_path / "jax.pth")
    jckpt.export_reference_checkpoint(params, pth)
    answers = []
    real = jserving.Registrar.register
    monkeypatch.setattr(jserving.Registrar, "register",
                        lambda self, *a, **kw: answers.append(real(self, *a, **kw)) or answers[-1])
    argv = ["--checkpoint", pth, "--parity", "--n", "128"]
    jax_text = _run_jax_script("register_pair.py", argv, monkeypatch)
    got, text = _quiet(register_pair.main, argv + ["--device", "cpu"])
    R, t, info = answers[0]
    d = np.linalg.norm(np.asarray(R) - got["R"]) / np.sqrt(2)
    assert d < 1e-4 and np.abs(np.asarray(t) - got["t"]).max() < 1e-4, (d, t, got["t"])
    assert abs(got["similarity_mean"] - float(info["similarity_mean"])) <= \
        1e-4 * abs(float(info["similarity_mean"]))
    heads = lambda s: [ln.split("=")[0].split(":")[0] for ln in s.splitlines() if "=" in ln
                       or ":" in ln]
    assert heads(text) == heads(jax_text), (text, jax_text)
    assert "vs GT: rotation error" in text


@pytest.mark.parametrize("mode", ["fast", "robust", "pkl"])
def test_register_pair_runs_in_each_mode(tmp_path, mode):
    argv = ["--n", "128", "--device", "cpu"]
    if mode == "robust":
        argv.append("--robust")
    if mode == "pkl":
        from se3_equi_graph_registration_tpu_torch.data.synthetic import (
            write_reference_test_archive)

        names = write_reference_test_archive(str(tmp_path), n_pairs=1, n_points=300)
        argv += ["--pkl", str(tmp_path / "test_3dmatch" / names[0])]
    out, text = _quiet(register_pair.main, argv)
    assert out["R"].shape == (3, 3) and abs(np.linalg.det(out["R"]) - 1) < 1e-4
    assert np.all(np.isfinite(out["t"])) and "rotation error" in text


def test_denoise_matches_the_jax_scripts_mses(monkeypatch):
    from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

    n, k, steps = 64, 8, 8
    jax_losses, jax_init, real_jit = [], [], jax.jit

    def recording_jit(fn=None, **kw):
        """jax.jit, but the script's train step also records the weights
        it starts from (its `model.init(PRNGKey(0), ...)`) and each loss."""
        jitted = real_jit(fn, **kw)
        if getattr(fn, "__name__", "") != "step":
            return jitted

        def call(*a):
            if not jax_init:
                jax_init.append(jax.tree_util.tree_map(np.asarray, a[0]))
            out = jitted(*a)
            jax_losses.append(float(out[2]))
            return out
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    jax_text = _run_jax_script("denoise.py", ["--steps", str(steps), "--n", str(n), "--k",
                                              str(k)], monkeypatch)
    monkeypatch.setattr(jax, "jit", real_jit)
    sd = {key[len("egnn."):]: v for key, v in params_from_jax(
        {"egnn": jax_init[0]["params"], "mlp": {}}).items()}
    lines = []
    got = denoise.denoise(steps, n, k, 0.1, 4, device="cpu", state_dict=sd, log=lines.append)
    assert len(jax_losses) == len(got["losses"]) == steps
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-4)
    # the printed baseline is the same number, and the lines are the script's
    jax_lines = jax_text.strip().splitlines()
    assert lines[0] == jax_lines[0] and lines[-1] == jax_lines[-1] == "done", (lines, jax_lines)
    assert len(lines) == len(jax_lines)
    assert got["losses"][4] != got["losses"][3]


def test_global_registration_recovers_the_pose():
    out, text = _quiet(global_registration.main, ["--n-points", "512", "--device", "cpu"])
    assert out["rot_err_deg"] < 1.0, text
    assert "vs ground truth" in text and "pose sigma" in text


def test_multihost_demo_ranks_agree_with_one_process(monkeypatch):
    """Two gloo ranks, each with 8 of the 16 pairs a step, against one
    process with all 16: the same global loss each epoch. The ranks run on
    one thread each (the demo keeps a caller's OMP_NUM_THREADS)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ranks, text = _quiet(multihost_train.demo, 2, 16)
    assert "both processes finished" in text and ranks[0] == ranks[1] and len(ranks[0]) == 2
    one, text = _quiet(multihost_train.worker, None, 1, 0, 2, 16, "cpu")
    assert "process 0/1: loss" in text
    np.testing.assert_allclose(ranks[0], one, rtol=1e-5)


@pytest.mark.parametrize("example,argv", [
    (register_pair, ["--n", "128"]),
    (global_registration, ["--n-points", "256"]),
    (denoise, ["--steps", "1", "--n", "32", "--k", "4"]),
    (multihost_train, ["--n", "32"]),
], ids=["register_pair", "global_registration", "denoise", "multihost_train"])
def test_each_twin_raises_without_a_card(monkeypatch, example, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main(argv)

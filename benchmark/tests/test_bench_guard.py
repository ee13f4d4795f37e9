"""The guard against JAX: top-level names compared whole, and a process
that loads the harness, its entries and what they import of the port
holds none of them."""
import os
import subprocess
import sys

from benchmark import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_names_are_compared_whole():
    assert guard.jax_modules(["jax.numpy", "numpy", "flax.linen"]) == ["flax", "jax"]
    assert guard.jax_modules(["se3_equi_graph_registration_tpu.ops.knn"]) == [
        "se3_equi_graph_registration_tpu"]
    assert guard.jax_modules(["se3_equi_graph_registration_tpu_torch.serving", "jaxtyping",
                              "jaxlibx"]) == []


def test_a_run_loads_no_jax():
    code = ("import benchmark.run as r, benchmark.calibrate, benchmark.entries.train_step, "
            "benchmark.entries.register, benchmark.reference.model\n"
            "from se3_equi_graph_registration_tpu_torch import serving\n"
            "from se3_equi_graph_registration_tpu_torch.train import engine\n"
            "from se3_equi_graph_registration_tpu_torch.ops.kernels import build\n"
            "import benchmark.guard as g; print(g.jax_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    src = open(os.path.join(ROOT, "benchmark", "reference", "model.py")).read()
    assert "se3_equi_graph_registration_tpu" not in src and "jax" not in src.replace(
        "nothing of JAX", "")

"""PyTorch / CUDA port of `se3_equi_graph_registration_tpu` for NVIDIA Hopper.

The JAX package beside this one is the frozen reference; every module here
mirrors its path so each counterpart is easy to find. This package imports
torch and numpy only — never jax and never the JAX package (importing any
of its submodules would run its jax-importing `__init__`).

Entry points (`serving.Registrar`, `train.engine.build_model`, the engine's
forward) run on the CUDA card unless the caller passes `device="cpu"`; with
no card and no explicit CPU device they raise. The hand-written kernels
(`csrc/*.cu`, bound in `ops/kernels/`) build with `nvcc` at first use.

Importing this package imports nothing heavy.
"""

__version__ = "0.1.0"

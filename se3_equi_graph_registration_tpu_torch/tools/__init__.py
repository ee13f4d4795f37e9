"""Tools of the port: `eval_files` (pairwise evaluation from files),
`multiway` (the pose graph over `.log` files), `stats` (a dataset's
inlier-ratio statistics), `grad_budget` (the fast-against-accurate gradient
table) and `scenario_table` (the checkpoint-free pipeline's success counts
on drawn surfaces). The JAX package's `viz` is not ported yet (ROADMAP,
Queue A)."""
from . import eval_files, stats  # noqa: F401

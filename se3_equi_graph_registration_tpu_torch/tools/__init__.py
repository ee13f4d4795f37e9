"""Tools of the port: `eval_files` (pairwise evaluation from files),
`multiway` (the pose graph over `.log` files), `stats` (a dataset's
inlier-ratio statistics), `grad_budget` (the fast-against-accurate gradient
table), `scenario_table` (the checkpoint-free pipeline's success counts on
drawn surfaces) and `viz` (matplotlib plots of registrations,
correspondences and descriptors; matplotlib is imported only when a plot is
drawn)."""
from . import eval_files, stats, viz  # noqa: F401

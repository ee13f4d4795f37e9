"""Command-line tools of the port: `eval_files` (pairwise evaluation from
files) and `multiway` (the pose graph over `.log` files). The JAX package's
`stats`, `viz` and `grad_budget` are not ported yet (ROADMAP, Queue A)."""

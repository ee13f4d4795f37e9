"""The JAX package's `examples/` scripts, on the port: `register_pair`,
`global_registration`, `denoise` and `multihost_train` (the scenario table
and multiway registration are `tools/scenario_table.py` and
`tools/multiway.py`). Each runs as

    python -m se3_equi_graph_registration_tpu_torch.examples.<name> [flags]

with the JAX script's flags plus `--device` (default: the CUDA card; with
no card and no `--device cpu` it raises), prints the JAX script's lines,
and keeps its work in a function that returns the numbers it prints."""

"""Models of the port (counterparts of `se3_equi_graph_registration_tpu.models`)."""

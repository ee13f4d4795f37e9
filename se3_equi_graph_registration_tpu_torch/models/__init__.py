"""Models of the port (counterparts of `se3_equi_graph_registration_tpu.models`):
`egnn` (the EGNN), `pose_head` (the registration heads), `pointnet` (the
PointNet encoder) and `variants` (the model zoo: the clean EGNN, the
GCL / radial-field / ClofNet / velocity layers, the SO(3) tensor-product
layer and the legacy dense GCN)."""

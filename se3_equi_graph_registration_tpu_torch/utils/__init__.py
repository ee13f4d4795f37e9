"""Utilities of the port: timing, metrics logging, failure detection,
trajectories, bf16 training (`bf16_training`), small tensor functions
(`nn_extras`) and reversible residual blocks (`reversible`)."""

"""Device operations a serving call in the traced window, as
`train_launches_per_step` counts them a step."""
from benchmark.metrics.train_launches_per_step import read  # noqa: F401

from . import basis, spherical_harmonics, wigner  # noqa: F401

"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor (or raises); there is no fallback. Each wrapper
counts its launches in a plain int attribute, `<wrapper>.launches`.
"""

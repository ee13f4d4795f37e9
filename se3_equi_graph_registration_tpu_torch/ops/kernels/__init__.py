"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor (or raises); there is no fallback. The
inference kernels (B1, B2, B4, B5) launch through custom ops in the
`se3gspr_torch` namespace (`torch.library.custom_op`, CUDA only, with fake
implementations), so `torch.export` traces them; the wrapper checks shapes
and picks the variant before the op, the op's CUDA side allocates, launches
and counts. Each wrapper counts its launches in a plain int attribute,
`<wrapper>.launches`, at call time.
"""


def load_program(path: str):
    """Load a `torch.export` artifact of the port (`serving.Registrar.
    export_compiled`, `registration.export_compiled`): registers the ops,
    then returns a callable that runs the program under `torch.no_grad()`
    and in full float32 matrix products (`ops/numerics.fp32_matmuls`: TF32
    is process state, not part of a graph, so the artifact cannot carry the
    setting). A deployment site needs torch and this op library only."""
    import torch

    from ..numerics import fp32_matmuls

    register_ops()
    program = torch.export.load(path).module()

    def call(*args):
        with torch.no_grad(), fp32_matmuls():
            return program(*args)
    return call


def register_ops() -> None:
    """Register the kernels' custom ops (`torch.ops.se3gspr_torch`: knn_window,
    knn_chunked, egcl_layer, spfh), which a process needs before it loads an
    exported program that calls them. Importing the modules registers them;
    nothing builds until a kernel launches."""
    from . import egcl, knn, spfh  # noqa: F401

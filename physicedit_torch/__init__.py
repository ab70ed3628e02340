"""PhysicEdit on PyTorch and CUDA: the port of ``physicedit_tpu`` to one
NVIDIA H100.

The JAX package stays the reference; this package keeps its module names so
each counterpart is easy to find, and it never imports JAX.  Host-only
helpers that import no JAX (``physicedit_tpu.sampling.flow_match``,
``physicedit_tpu.pipeline.prompt``, ``physicedit_tpu.pipeline.vl_host``)
are imported, not copied.

Package map:
    core/      linear layers and their random init
    io/        JAX parameter trees -> this package's modules
    ops/       norms, RoPE, patchify, plain attention
    kernels/   hand-written Hopper kernels (``csrc/``), their builder and
               plain PyTorch versions
    models/    dit, vae, qwen2.5-vl text and vision, adapters
    sampling/  the CFG denoise loop
    pipeline/  the edit pipeline and its random-weight factory
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "PhysicEditPipeline":
        from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

        return PhysicEditPipeline
    raise AttributeError(name)

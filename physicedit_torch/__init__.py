"""PhysicEdit on PyTorch and CUDA: the port of ``physicedit_tpu`` to one
NVIDIA H100.

The JAX package stays the reference; this package keeps its module names so
each counterpart is easy to find.  It imports neither JAX nor anything of
``physicedit_tpu``: the host-only helpers it shares with the JAX package
(``sampling/flow_match.py``, ``sampling/ddim.py``,
``sampling/continuous_ode.py``, ``data/video.py``, ``pipeline/prompt.py``,
``pipeline/vl_host.py``) are copies of their own.

Package map:
    core/      linear layers and their random init
    io/        JAX parameter trees -> this package's modules, and back
    ops/       norms, RoPE, patchify, plain attention
    kernels/   hand-written Hopper kernels (``csrc/``), their builder and
               plain PyTorch versions
    models/    dit, vae (and vae3d, its video mode), qwen2.5-vl text and
               vision, adapters and resamplers, dinov2
    lora.py    the DiT's trainable LoRA factors and their peft export
    sampling/  the flow-match schedule and the CFG denoise loop; the
               legacy DDIM and continuous-ODE schedules
    data/      video and image-folder IO
    extensions/ the video post-processing chain (FastBlend, RIFE, the PIL
               editors), the ESRGAN upscaler and the tiler
    pipeline/  the edit pipeline, its host helpers, the visual priors and
               the random-weight factory
    train/     the PhysicEdit loss, the AdamW step, the trainer and the
               checkpoint export
    parallel/  several GPUs: the mesh and its specs, tensor parallelism,
               ring and Ulysses attention, the process group
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "PhysicEditPipeline":
        from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

        return PhysicEditPipeline
    raise AttributeError(name)

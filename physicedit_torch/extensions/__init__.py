"""Legacy DiffSynth extension zoo (``physicedit_tpu/extensions``): the
video post-processing chain (FastBlend, RIFE, the PIL editors and their
sequential processor), the ESRGAN upscaler, the tiler, and the image
quality / preference-score registry with its CLIP BPE.

Lazy exports: importing this package stays cheap; submodules load on first
attribute access.
"""

_EXPORTS = {
    "esrgan": "physicedit_torch.extensions.esrgan",
    "rife": "physicedit_torch.extensions.rife",
    "tiler": "physicedit_torch.extensions.tiler",
    "fastblend": "physicedit_torch.extensions.fastblend",
    "processors": "physicedit_torch.extensions.processors",
    "quality_metric": "physicedit_torch.extensions.quality_metric",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return importlib.import_module(_EXPORTS[name])
    raise AttributeError(name)

"""Sequential video-processor chain — the reference's `processors/` DSL
(``physicedit_tpu/extensions/processors.py``).

Rebuilds:

- ``VideoProcessor`` protocol (diffsynth/processors/base.py:1-7),
- PIL frame editors (diffsynth/processors/PILEditor.py:5-32),
- the type registry + chain
  (diffsynth/processors/sequencial_processor.py:4-41),
- smoother adapters: the reference's processors/FastBlend.py and
  processors/RIFE.py; here they dispatch to the port's FastBlend
  (extensions/fastblend.py) and IFNet (extensions/rife.py) smoothers.

The reference constructs processors ``from_model_manager(manager,
config)``; this build has no global model manager, so the registry
instead takes an optional ``models`` mapping — ``{"rife": <an IFNet>}`` —
plus per-processor config kwargs, which keeps construction pure and
testable.  FastBlend runs on ``device`` (the card unless a caller passes
``"cpu"``); RIFE on its network's device (``model_path`` loads it onto
``device``).
"""

from __future__ import annotations


class VideoProcessor:
    """Frames-in/frames-out protocol (processors/base.py:1-7)."""

    def __call__(self, rendered_frames, **kwargs):
        raise NotImplementedError


class ContrastEditor(VideoProcessor):
    """PIL contrast enhance per frame (PILEditor.py:5-17)."""

    def __init__(self, rate=1.5):
        self.rate = rate

    def __call__(self, rendered_frames, **kwargs):
        from PIL import ImageEnhance

        return [ImageEnhance.Contrast(f).enhance(self.rate)
                for f in rendered_frames]


class SharpnessEditor(VideoProcessor):
    """PIL sharpness enhance per frame (PILEditor.py:20-32)."""

    def __init__(self, rate=1.5):
        self.rate = rate

    def __call__(self, rendered_frames, **kwargs):
        from PIL import ImageEnhance

        return [ImageEnhance.Sharpness(f).enhance(self.rate)
                for f in rendered_frames]


def make_processor(processor_type, models=None, device="cuda", **config):
    """Registry dispatch (sequencial_processor.py:4-23).

    ``models`` supplies weights for processors that need them ("RIFE"
    expects ``models["rife"]`` = an IFNet, or a ``model_path`` in
    ``config`` to load via :func:`extensions.rife.load_rife`).
    """
    models = models or {}
    if processor_type == "FastBlend":
        from physicedit_torch.extensions import fastblend

        proc = fastblend.FastBlendSmoother(device)
        for key in ("batch_size", "window_size"):
            if key in config:
                setattr(proc, key, config.pop(key))
        proc.ebsynth_config.update(config)
        return proc
    if processor_type == "RIFE":
        from physicedit_torch.extensions import rife

        if "model_path" in config:
            net = rife.load_rife(config.pop("model_path"), device)
        elif "rife" in models:
            net = models["rife"]
        else:
            raise ValueError("RIFE processor needs models['rife'] (an IFNet) "
                             "or a model_path in its config")
        proc = rife.RIFESmoother(net)
        proc.default_kwargs = config
        return proc
    if processor_type == "Contrast":
        return ContrastEditor(**config)
    if processor_type == "Sharpness":
        return SharpnessEditor(**config)
    raise ValueError(f"invalid processor_type: {processor_type}")


class SequencialProcessor(VideoProcessor):
    """Ordered chain of processors (sequencial_processor.py:26-41).

    Keeps the reference's (misspelled) class name for drop-in
    familiarity. Each config row is ``{"processor_type": ...,
    "config": {...}}``.
    """

    def __init__(self, processors=None):
        self.processors = list(processors or [])

    @classmethod
    def from_configs(cls, configs, models=None, device="cuda"):
        return cls([make_processor(c["processor_type"], models=models, device=device,
                                   **c.get("config", {}))
                    for c in configs])

    def __call__(self, rendered_frames, **kwargs):
        for proc in self.processors:
            call_kwargs = dict(getattr(proc, "default_kwargs", {}))
            call_kwargs.update(kwargs)
            rendered_frames = proc(rendered_frames, **call_kwargs)
        return rendered_frames

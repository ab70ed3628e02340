"""Random-weight pipelines with a fake tokenizer, for the tests and the chip
smoke run; no checkpoint or tokenizer files are needed.

``build_random_pipeline("tiny", ...)`` has the dims of the JAX package's
``build_tiny_pipeline``; ``"full"`` is Qwen-Image-Edit-2509 at full width
(60-block DiT, 28-layer Qwen2.5-VL-7B text model, 32-block ViT, the Qwen
VAE and a dual adapter at 3584 in and out).  At full size the weights are
drawn in the working dtype directly on the device from a generator on that
device: an fp32 init on the host would need about 112 GB of RAM.
"""

from __future__ import annotations

import dataclasses
import re
import zlib

import torch

from physicedit_torch.core.params import init_random_, materialize
from physicedit_torch.models.adapters import DualAdapter
from physicedit_torch.models.dit import QWEN_IMAGE_CONFIG, DiT, DiTConfig
from physicedit_torch.models.qwen_vl import (QWEN25_VL_7B_TEXT, TINY_TEXT, QwenVLText,
                                             QwenVLTextConfig)
from physicedit_torch.models.qwen_vl_vision import (QWEN25_VL_VISION, QwenVLVision,
                                                    QwenVLVisionConfig)
from physicedit_torch.models.vae import QWEN_VAE_CONFIG, VAE, VAEConfig
from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline


class FakeTokenizer:
    """Deterministic word / special-token tokenizer over a tiny vocab."""

    SPECIALS = {
        "<|image_pad|>": 99, "<|vision_start|>": 98, "<|vision_end|>": 97,
        "<begin_of_img>": 96, "<end_of_img>": 95, "<|im_start|>": 94,
        "<|im_end|>": 93,
    }

    def __init__(self):
        self.specials = dict(self.SPECIALS)
        for i in range(64):
            self.specials[f"<img{i}>"] = 200 + i
        self._pattern = re.compile("|".join(
            re.escape(t) for t in sorted(self.specials, key=len, reverse=True)))

    def __call__(self, text):
        ids = []
        pos = 0
        for m in self._pattern.finditer(text):
            ids.extend(self._words(text[pos:m.start()]))
            ids.append(self.specials[m.group(0)])
            pos = m.end()
        ids.extend(self._words(text[pos:]))

        class R:
            input_ids = ids

        return R()

    def _words(self, chunk):
        # ids in [300, 450), disjoint from the specials; crc32 is stable
        # across processes where str hash is salted
        return [300 + (zlib.crc32(w.encode()) % 150) for w in chunk.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"tok{i}" for i in ids)

    def convert_tokens_to_ids(self, tok):
        return self.specials[tok]


@dataclasses.dataclass(frozen=True)
class PipelineDims:
    dit: DiTConfig
    text: QwenVLTextConfig
    vision: QwenVLVisionConfig
    vae: VAEConfig
    adapter_dim: int
    rope_axes: tuple
    edit_drop_idx: int


SIZES = {
    "tiny": PipelineDims(
        dit=DiTConfig(num_layers=2, dim=64, num_heads=2, head_dim=32,
                      txt_in_dim=64, patch_dim=64, time_dim=32),
        text=TINY_TEXT,
        vision=QwenVLVisionConfig(depth=2, hidden_size=32, num_heads=2,
                                  intermediate_size=64, window_size=56,
                                  fullatt_block_indexes=(1,), out_hidden_size=64),
        vae=VAEConfig(base_dim=8), adapter_dim=64, rope_axes=(8, 12, 12),
        edit_drop_idx=2),
    "full": PipelineDims(
        dit=QWEN_IMAGE_CONFIG, text=QWEN25_VL_7B_TEXT, vision=QWEN25_VL_VISION,
        vae=QWEN_VAE_CONFIG, adapter_dim=3584, rope_axes=(16, 56, 56),
        edit_drop_idx=64),
}


@torch.no_grad()
def random_pipeline(dims: PipelineDims, device="cpu", dtype=torch.float32,
                    generator: torch.Generator | None = None) -> PhysicEditPipeline:
    """A pipeline of the given dims with torch-default random weights (the
    distribution of the JAX package's ``linear_init``; token embeddings
    N(0, 0.02^2)), every model built in ``dtype`` on ``device``."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)

    def make(module):
        return init_random_(materialize(module, device), generator).eval()

    text = materialize(QwenVLText(dims.text, dtype), device)
    init_random_(text, generator)
    text.embed.normal_(0.0, 0.02, generator=generator)
    tok = FakeTokenizer()
    return PhysicEditPipeline(
        dit=make(DiT(dims.dit, dtype)), vae=make(VAE(dims.vae, dtype)),
        text=text.eval(), vision=make(QwenVLVision(dims.vision, dtype)),
        adapter=make(DualAdapter(dims.adapter_dim, dims.adapter_dim, dtype)),
        tokenizer=tok, dtype=dtype, device=device,
        boi_token_id=tok.specials["<begin_of_img>"],
        eoi_token_id=tok.specials["<end_of_img>"],
        image_pad_id=tok.specials["<|image_pad|>"],
        vision_start_id=tok.specials["<|vision_start|>"],
        edit_drop_idx=dims.edit_drop_idx,
        rope_axes=dims.rope_axes)


def build_random_pipeline(size: str = "tiny", device="cpu",
                          generator: torch.Generator | None = None,
                          quantize: str | None = None) -> PhysicEditPipeline:
    """``"tiny"`` in fp32 or ``"full"`` in bf16, with random weights; with
    ``quantize`` ("int4") built in the working dtype and then quantized in
    place (``PhysicEditPipeline.quantize_``), so the peak stays near the
    float pipeline's size."""
    dtype = torch.bfloat16 if size == "full" else torch.float32
    pipe = random_pipeline(SIZES[size], device, dtype, generator)
    return pipe if quantize is None else pipe.quantize_(quantize)

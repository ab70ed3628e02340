"""Prompt refiners, BeautifulPrompt / QwenPrompt / Translator
(``physicedit_tpu/pipeline/prompt_refiners.py``, the reference's
``diffsynth/prompters/prompt_refiners.py``):

- BeautifulPrompt: a BLOOM causal LM (``models/bloom.py``); the template
  chosen by whether the model path ends in "v2"; sampled generation (384
  new tokens, temperature 0.9, top-k 50, top-p 0.95, repetition penalty
  1.1) from a ``torch.Generator`` seeded per call; returns
  ``raw_prompt + ", " + generation``, and a negative prompt unchanged.
- QwenPrompt: a Qwen2 instruct LM, run as the text decoder of
  ``models/qwen_vl.py`` (M-RoPE with three equal position rows is 1-D
  RoPE): the verbatim system prompt, the chat template, a greedy decode of
  up to 512 tokens; returns the generation alone.  Its prefill is left
  padded to a multiple of 128, so on the card its attention is kernel K2.
- Translator: MarianMT opus-mt-zh-en (``models/marian.py``), greedy.

Prompts are padded to buckets (64, or 128 for QwenPrompt), the JAX
package's shapes.  Tokenizers are injectable (any object with the used part
of the HF tokenizer API); ``from_pretrained`` takes an HF
``AutoTokenizer`` when none is given.  Models run on ``cuda`` unless the
caller passes another device.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

BEAUTIFUL_TEMPLATE_V1 = (
    "Instruction: Give a simple description of the image to generate a "
    "drawing prompt.\nInput: {raw_prompt}\nOutput:")
BEAUTIFUL_TEMPLATE_V2 = """Converts a simple image description into a prompt. \
Prompts are formatted as multiple related tags separated by commas, plus you can use () to increase the weight, [] to decrease the weight, \
or use a number to specify the weight. You should add appropriate words to make the images described in the prompt more aesthetically pleasing, \
but make sure there is a correlation between the input and output.\n\
### Input: {raw_prompt}\n### Output:"""

QWEN_PROMPT_SYSTEM = """You are an English image describer. Here are some example image styles:\n\n1. Extreme close-up: Clear focus on a single object with a blurred background, highlighted under natural sunlight.\n2. Vintage: A photograph of a historical scene, using techniques such as Daguerreotype or cyanotype.\n3. Anime: A stylized cartoon image, emphasizing hyper-realistic portraits and luminous brushwork.\n4. Candid: A natural, unposed shot capturing spontaneous moments, often with cinematic qualities.\n5. Landscape: A photorealistic image of natural scenery, such as a sunrise over the sea.\n6. Design: Colorful and detailed illustrations, often in the style of 2D game art or botanical illustrations.\n7. Urban: An ultrarealistic scene in a modern setting, possibly a cityscape viewed from indoors.\n\nYour task is to translate a given Chinese image description into a concise and precise English description. Ensure that the imagery is vivid and descriptive, and include stylistic elements to enrich the description.\nPlease note the following points:\n\n1. Capture the essence and mood of the Chinese description without including direct phrases or words from the examples provided.\n2. You should add appropriate words to make the images described in the prompt more aesthetically pleasing. If the Chinese description does not specify a style, you need to add some stylistic descriptions based on the essence of the Chinese text.\n3. The generated English description should not exceed 200 words.\n\n"""

# Qwen/Qwen2-1.5B-Instruct, config.json (tied embeddings: no lm_head.weight)
QWEN2_1_5B_INSTRUCT = {
    "vocab_size": 151936, "hidden_size": 1536, "num_hidden_layers": 28,
    "num_attention_heads": 12, "num_key_value_heads": 2, "intermediate_size": 8960,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "eos_token_id": 151645,
    "tie_word_embeddings": True}


def _bucket(n: int, step: int = 64) -> int:
    return max(step, ((n + step - 1) // step) * step)


def _even_mrope_sections(half: int) -> tuple:
    """A 3-way split of head_dim / 2 for text-only decoding: the three
    M-RoPE position rows are equal, so any split that sums to head_dim / 2
    gives 1-D RoPE."""
    third = half // 3
    return (half - 2 * third, third, third)


def qwen_text_cfg_from_hf(hf_cfg: dict):
    """The text decoder's config from a text-only Qwen2 / Qwen2.5 HF config
    dict: head_dim when given (Qwen2-0.5B's 64 is not hidden / heads), the
    first EOS of a list, and an M-RoPE split that fits head_dim."""
    from physicedit_torch.models.qwen_vl import QwenVLTextConfig

    hidden = hf_cfg["hidden_size"]
    heads = hf_cfg["num_attention_heads"]
    head_dim = hf_cfg.get("head_dim") or hidden // heads
    eos = hf_cfg.get("eos_token_id", 151645)
    rope_scaling = hf_cfg.get("rope_scaling") or {}
    sections = rope_scaling.get("mrope_section")
    return QwenVLTextConfig(
        vocab_size=hf_cfg["vocab_size"], hidden_size=hidden,
        num_layers=hf_cfg["num_hidden_layers"], num_heads=heads,
        num_kv_heads=hf_cfg["num_key_value_heads"], head_dim=head_dim,
        intermediate_size=hf_cfg["intermediate_size"],
        rope_theta=hf_cfg.get("rope_theta", 1e6), eps=hf_cfg.get("rms_norm_eps", 1e-6),
        mrope_section=tuple(sections) if sections else _even_mrope_sections(head_dim // 2),
        eos_token_id=eos[0] if isinstance(eos, list) else eos)


def _load_hf_folder(path: str):
    """(config dict, state dict) of an HF model folder: ``config.json`` and
    its ``model*.safetensors`` / ``pytorch_model*.bin`` shards."""
    from physicedit_torch.io.safetensors_io import load_safetensors

    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    sd = {}
    for name in sorted(os.listdir(path)):
        fp = os.path.join(path, name)
        if name.endswith(".safetensors"):
            sd.update(load_safetensors(fp))
        elif name.startswith("pytorch_model") and name.endswith(".bin"):
            sd.update(torch.load(fp, map_location="cpu", weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no weight shards under {path}")
    return cfg, sd


def _auto_tokenizer(path: str):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def _until_eos(toks, eos: int) -> list:
    keep = []
    for t in toks:
        if t == eos:
            break
        keep.append(t)
    return keep


def _device(model) -> torch.device:
    return next(model.parameters()).device


class BeautifulPrompt:
    """The text-to-image prompt beautifier over :class:`models.bloom.Bloom`."""

    def __init__(self, model, tokenizer, template: str = ""):
        self.model, self.cfg = model, model.cfg
        self.tokenizer = tokenizer
        self.template = template or BEAUTIFUL_TEMPLATE_V1

    @classmethod
    def from_pretrained(cls, path: str, tokenizer=None, dtype=torch.bfloat16,
                        device="cuda") -> "BeautifulPrompt":
        from physicedit_torch.models import bloom

        hf_cfg, sd = _load_hf_folder(path)
        cfg = bloom.BloomConfig(
            vocab_size=hf_cfg["vocab_size"],
            hidden_size=hf_cfg.get("hidden_size", hf_cfg.get("n_embed")),
            num_layers=hf_cfg["n_layer"], num_heads=hf_cfg["n_head"],
            eos_token_id=hf_cfg.get("eos_token_id", 2),
            pad_token_id=hf_cfg.get("pad_token_id") or 3,
            eps=hf_cfg.get("layer_norm_epsilon", 1e-5))
        model = bloom.bloom_from_state_dict(sd, cfg, dtype, device)
        template = (BEAUTIFUL_TEMPLATE_V2 if path.rstrip("/").endswith("v2")
                    else BEAUTIFUL_TEMPLATE_V1)
        return cls(model, tokenizer or _auto_tokenizer(path), template)

    def __call__(self, raw_prompt: str, positive: bool = True, seed: int = 0,
                 **kwargs) -> str:
        if not positive:
            return raw_prompt
        from physicedit_torch.models import bloom

        dev = _device(self.model)
        ids = self.tokenizer.encode(self.template.format(raw_prompt=raw_prompt))
        pad = _bucket(len(ids))
        input_ids = np.full((1, pad), self.cfg.pad_token_id, np.int64)
        mask = np.zeros((1, pad), np.int64)
        input_ids[0, pad - len(ids):] = ids     # left-padded: the generation abuts
        mask[0, pad - len(ids):] = 1
        toks = bloom.bloom_generate(
            self.model, torch.from_numpy(input_ids).to(dev), torch.from_numpy(mask).to(dev),
            max_new_tokens=384, do_sample=True, temperature=0.9, top_k=50,
            top_p=0.95, repetition_penalty=1.1,
            generator=torch.Generator(dev).manual_seed(seed))
        out = self.tokenizer.decode(_until_eos(toks[0].tolist(), self.cfg.eos_token_id),
                                    skip_special_tokens=True)
        return raw_prompt + ", " + out.strip()


class QwenPrompt:
    """The Chinese-to-English prompt translator and enhancer over the text
    decoder of ``models/qwen_vl.py``."""

    def __init__(self, text, tokenizer, system_prompt: str = QWEN_PROMPT_SYSTEM):
        self.text, self.cfg = text, text.cfg
        self.tokenizer = tokenizer
        self.system_prompt = system_prompt

    @classmethod
    def from_pretrained(cls, path: str, tokenizer=None, dtype=torch.bfloat16,
                        device="cuda") -> "QwenPrompt":
        from physicedit_torch.io.convert import qwen_vl_text_from_state_dict

        hf_cfg, sd = _load_hf_folder(path)
        if "lm_head.weight" not in sd:      # tied embeddings (Qwen2 up to 1.5B)
            sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
        text = qwen_vl_text_from_state_dict(sd, qwen_text_cfg_from_hf(hf_cfg), dtype, device)
        return cls(text, tokenizer or _auto_tokenizer(path))

    def inputs(self, raw_prompt: str):
        """The padded prefill of one prompt: (ids, embeds [1, pad, D] in the
        model's dtype, rope positions [3, 1, pad], key mask [1, pad])."""
        text, dev = self.text, _device(self.text)
        chat = self.tokenizer.apply_chat_template(
            [{"role": "system", "content": self.system_prompt},
             {"role": "user", "content": raw_prompt}],
            tokenize=False, add_generation_prompt=True)
        ids = self.tokenizer.encode(chat)
        n = len(ids)
        pad = _bucket(n, 128)
        dtype = text.norm.scale.dtype
        embeds = torch.zeros((1, pad, self.cfg.hidden_size), dtype=dtype, device=dev)
        embeds[0, pad - n:] = text.embed_tokens(torch.tensor(ids, device=dev)).to(dtype)
        mask = torch.zeros((1, pad), dtype=torch.bool, device=dev)
        mask[0, pad - n:] = True
        pos = torch.zeros((3, 1, pad), dtype=torch.long, device=dev)
        pos[:, 0, pad - n:] = torch.arange(n, device=dev)     # 1-D RoPE on all three rows
        return ids, embeds, pos, mask

    def __call__(self, raw_prompt: str, positive: bool = True, max_new_tokens: int = 512,
                 **kwargs) -> str:
        if not positive:
            return raw_prompt
        ids, embeds, pos, mask = self.inputs(raw_prompt)
        pad = mask.shape[1]
        logits, caches, _ = self.text.prefill(embeds, pos, mask, pad + max_new_tokens)
        first = logits.argmax(-1)
        # greedy_decode emits the first token at output position 0 itself:
        # it is not prepended again
        key_mask = torch.cat([mask, torch.zeros((1, max_new_tokens), dtype=torch.bool,
                                                device=mask.device)], dim=1)
        toks, _ = self.text.greedy_decode(caches, first, pad,
                                          torch.tensor([len(ids)], device=mask.device),
                                          max_new_tokens, key_mask=key_mask)
        keep = _until_eos(toks[0].tolist(), self.cfg.eos_token_id)
        return self.tokenizer.decode(keep, skip_special_tokens=True).strip()


class Translator:
    """The opus-mt zh-to-en translator over :class:`models.marian.Marian`."""

    def __init__(self, model, tokenizer):
        self.model, self.cfg = model, model.cfg
        self.tokenizer = tokenizer

    @classmethod
    def from_pretrained(cls, path: str, tokenizer=None, dtype=torch.float32,
                        device="cuda") -> "Translator":
        from physicedit_torch.models import marian

        hf_cfg, sd = _load_hf_folder(path)
        model = marian.marian_from_state_dict(sd, marian.config_from_hf(hf_cfg), dtype, device)
        return cls(model, tokenizer or _auto_tokenizer(path))

    def __call__(self, prompt: str, max_new_tokens: int = 512, **kwargs) -> str:
        from physicedit_torch.models import marian

        dev = _device(self.model)
        ids = self.tokenizer.encode(prompt)
        pad = _bucket(len(ids))
        input_ids = np.full((1, pad), self.cfg.pad_token_id, np.int64)
        mask = np.zeros((1, pad), np.int64)
        input_ids[0, :len(ids)] = ids       # the encoder's input: right-padded, masked
        mask[0, :len(ids)] = 1
        toks = marian.marian_greedy_generate(self.model, torch.from_numpy(input_ids).to(dev),
                                             torch.from_numpy(mask).to(dev),
                                             max_new_tokens=max_new_tokens)
        keep = _until_eos(toks[0].tolist(), self.cfg.eos_token_id)
        return self.tokenizer.decode(keep, skip_special_tokens=True).strip()


REFINER_KINDS = {"beautiful": BeautifulPrompt, "qwen": QwenPrompt, "translate": Translator}


def make_prompt_refiner(spec: str | None, device="cuda"):
    """``kind:/model/path`` -> the refiner, a callable prompt -> prompt, or
    None for no spec.  ``kind`` is ``beautiful``, ``qwen`` or ``translate``
    (the reference's BeautifulPrompt / QwenPrompt / Translator); the path is
    the HF model folder.  The instance is returned itself, so its options
    (``positive=``, ``seed=``, ``max_new_tokens=``) stay reachable."""
    if not spec:
        return None
    kind, sep, path = spec.partition(":")
    if not sep or kind not in REFINER_KINDS:
        raise ValueError(f"--prompt_refiner expects kind:path with kind in "
                         f"{sorted(REFINER_KINDS)}; got {spec!r}")
    return REFINER_KINDS[kind].from_pretrained(path, device=device)

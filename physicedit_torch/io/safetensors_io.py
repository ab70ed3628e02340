"""Safetensors reading and writing, state-dict key hashing and model
detection (``physicedit_tpu/io/safetensors_io.py``), without the
``safetensors`` package.

The format: a u64 little-endian header length, a JSON header naming each
tensor's dtype, shape and byte range, then the raw little-endian bytes.  A
file is read from a private ``mmap``: each tensor is a ``torch.frombuffer``
view of the mapping (no copy until a caller moves it to a device or casts
it).  The writer takes torch tensors (any device, any of the dtypes below)
or NumPy arrays and writes them in their own dtype, one tensor at a time.

The hash-based detection is the reference's scheme: md5 over the sorted
"key:shape" and "key" strings, so the published checkpoints' hashes name
their model families:

    0319a1cb19835fb510907dd3367c95ff  qwen_image_dit
    8004730443f55db63092006dd9f7110e  qwen_image_text_encoder (Qwen2.5-VL)
    ed4ea5824d55ec3107b09815e318123a  qwen_image_vae
    073bce9cf969e317e5662cd570c3e79c  qwen_image_blockwise_controlnet
    a9e54e480a628f0b956a688a81c33bab  qwen_image_blockwise_controlnet (inpaint)
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os

import numpy as np
import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16,
          "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def read_header(path: str) -> tuple[dict, int]:
    """(header without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_safetensors(path: str) -> dict:
    """One .safetensors file -> {name: CPU tensor}, each a view of a private
    (copy-on-write) mapping of the file."""
    header, base = read_header(path)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > base else None
    out = {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which is "
                             f"not read (known: {sorted(DTYPES)})")
        shape = tuple(info["shape"])
        lo, hi = info["data_offsets"]
        numel = int(np.prod(shape, dtype=np.int64))
        if hi - lo != numel * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: tensor {name} spans {hi - lo} bytes for shape {shape}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(mm, dtype=torch.uint8, count=hi - lo, offset=base + lo)
        out[name] = t.view(dtype).reshape(shape)
    return out


def load_state_dict(path) -> dict:
    """A file, a list of shards, or a folder of shards -> one flat dict."""
    if isinstance(path, (list, tuple)):
        sd = {}
        for p in path:
            sd.update(load_state_dict(p))
        return sd
    if os.path.isdir(path):
        sd = {}
        for name in sorted(os.listdir(path)):
            if name.endswith(".safetensors"):
                sd.update(load_safetensors(os.path.join(path, name)))
        return sd
    return load_safetensors(path)


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.ascontiguousarray(v))


def save_safetensors(sd: dict, path: str) -> int:
    """Write ``{name: tensor or array}`` in the safetensors format, each in
    its own dtype: the u64 little-endian header length, the JSON header
    (padded with spaces to 8 bytes), then each tensor's little-endian bytes
    in the header's (sorted) order.  Tensors are copied to the host one at a
    time.  Written to a temporary name and renamed; returns the bytes of
    tensor data."""
    names = sorted(sd)
    header, offset = {}, 0
    for name in names:
        t = sd[name]
        dtype = (t.dtype if isinstance(t, torch.Tensor)
                 else torch.from_numpy(np.empty(0, np.asarray(t).dtype)).dtype)
        nbytes = int(np.prod(t.shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype).element_size()
        header[name] = {"dtype": _NAMES[dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name in names:
            t = _as_tensor(sd[name]).contiguous().cpu().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().data)
    os.replace(tmp, path)
    return offset


def state_dict_keys_str(sd: dict, with_shape: bool = True) -> str:
    """The reference's canonical key string: per tensor both
    "key:d0_d1_..." and "key", sorted, comma-joined; nested dicts become
    "key|<recursive>"."""
    keys = []
    for key, value in sd.items():
        if not isinstance(key, str):
            continue
        if isinstance(value, dict):
            keys.append(key + "|" + state_dict_keys_str(value, with_shape))
        elif hasattr(value, "shape"):
            if with_shape:
                keys.append(key + ":" + "_".join(map(str, list(value.shape))))
            keys.append(key)
    keys.sort()
    return ",".join(keys)


def hash_state_dict_keys(sd: dict, with_shape: bool = True) -> str:
    return hashlib.md5(state_dict_keys_str(sd, with_shape).encode("utf-8")).hexdigest()


# hash -> canonical model name (the reference's configs/model_config.py)
KNOWN_HASHES = {
    "0319a1cb19835fb510907dd3367c95ff": "qwen_image_dit",
    "8004730443f55db63092006dd9f7110e": "qwen_image_text_encoder",
    "ed4ea5824d55ec3107b09815e318123a": "qwen_image_vae",
    "073bce9cf969e317e5662cd570c3e79c": "qwen_image_blockwise_controlnet",
    "a9e54e480a628f0b956a688a81c33bab": "qwen_image_blockwise_controlnet_inpaint",
    # legacy-zoo checkpoints, loadable only outside the pipeline
    "2bd19e845116e4f875a0a048e27fc219": "nexus_gen_llm",
    "9b9313d104ac4df27991352fec013fd4": "rife",
    "6b7116078c4170bfbeaedc8fe71f6649": "esrgan",
}

# Detectable, but not parts of the pipeline: the dotted paths of their loaders
EXTENSION_LOADERS = {
    "rife": "physicedit_torch.extensions.rife.load_rife",
    "esrgan": "physicedit_torch.extensions.esrgan.load_esrgan",
    "nexus_gen_llm": "physicedit_torch.models.nexus_gen.load_nexus_gen",
}


def detect_model_name(sd: dict) -> str | None:
    """Identify a state dict by its key/shape hash; falls back to key
    heuristics so finetuned variants with extra keys still resolve."""
    h = hash_state_dict_keys(sd)
    if h in KNOWN_HASHES:
        return KNOWN_HASHES[h]
    keys = sd.keys()
    if any(k.startswith("transformer_blocks.") and ".attn.add_q_proj." in k for k in keys):
        return "qwen_image_dit"
    if any(k.startswith("encoder.down_blocks.") for k in keys) and "quant_conv.weight" in keys:
        return "qwen_image_vae"
    if any("visual.blocks." in k for k in keys) or any("language_model" in k for k in keys):
        return "qwen_image_text_encoder"
    if any(k.startswith("controlnet_blocks.") for k in keys):
        return "qwen_image_blockwise_controlnet"
    if any(".rdb1.conv1." in k for k in keys):
        return "esrgan"
    if any(k.replace("module.", "").startswith("block0.convblock") for k in keys):
        return "rife"
    return None

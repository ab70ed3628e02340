"""ESRGAN 4x upscaler (RRDBNet) (``physicedit_tpu/extensions/esrgan.py``).

The reference extension (DiffSynth-Studio/diffsynth/extensions/ESRGAN/
__init__.py:7-137): a 23-block RRDB super-resolution network with
nearest-neighbour 2x + 2x upsampling, in fp32 (the reference registry
upcasts ESRGAN to float32).  The modules carry the reference's own names
(``conv_first``, ``body.{i}.rdb{j}.conv{k}``, ...), so a Real-ESRGAN state
dict loads into :class:`RRDBNet` as it is; the JAX package's scan layout
(``body`` stacked on a leading axis) comes across through
``io/from_jax.load_tree_``.

:func:`rrdbnet_forward` keeps the JAX package's NHWC interface; inside, the
convolutions run on the NHWC memory as channels-last NCHW (the permute is a
view).  :func:`upscale` is the reference's PIL in / PIL out wrapper;
it converts to uint8 by truncation after the clip, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import init_random_, materialize


def _conv(cin, cout):
    return nn.Conv2d(cin, cout, 3, padding=1, device="meta")


class RDB(nn.Module):
    """ResidualDenseBlock (ESRGAN/__init__.py:7-24): 5 densely-connected
    convs over channel-concatenated inputs, a 0.2-scaled residual."""

    def __init__(self, num_feat, num_grow_ch):
        super().__init__()
        for i in range(5):
            self.add_module(f"conv{i + 1}", _conv(num_feat + i * num_grow_ch,
                                                  num_grow_ch if i < 4 else num_feat))

    def forward(self, x):
        feats = [x, F.leaky_relu(self.conv1(x), 0.2)]
        for i in range(2, 5):
            feats.append(F.leaky_relu(getattr(self, f"conv{i}")(torch.cat(feats, 1)), 0.2))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    """RRDB (ESRGAN/__init__.py:27-39): three RDBs, a 0.2-scaled residual."""

    def __init__(self, num_feat, num_grow_ch):
        super().__init__()
        self.rdb1 = RDB(num_feat, num_grow_ch)
        self.rdb2 = RDB(num_feat, num_grow_ch)
        self.rdb3 = RDB(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23, num_grow_ch=32):
        super().__init__()
        self.conv_first = _conv(num_in_ch, num_feat)
        self.body = nn.ModuleList(RRDB(num_feat, num_grow_ch) for _ in range(num_block))
        self.conv_body = _conv(num_feat, num_feat)
        self.conv_up1 = _conv(num_feat, num_feat)
        self.conv_up2 = _conv(num_feat, num_feat)
        self.conv_hr = _conv(num_feat, num_feat)
        self.conv_last = _conv(num_feat, num_out_ch)

    def forward(self, x):
        """x: [B, 3, H, W] -> [B, 3, 4H, 4W] (ESRGAN/__init__.py:56-67)."""
        feat = self.conv_first(x)
        h = feat
        for block in self.body:
            h = block(h)
        feat = feat + self.conv_body(h)
        for conv in (self.conv_up1, self.conv_up2):
            feat = F.leaky_relu(conv(F.interpolate(feat, scale_factor=2, mode="nearest")), 0.2)
        return self.conv_last(F.leaky_relu(self.conv_hr(feat), 0.2))


@torch.no_grad()
def rrdbnet_forward(net: RRDBNet, x: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, 3] float in [0, 1] -> [B, 4H, 4W, 3]."""
    return net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Init / loading
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_esrgan(generator: torch.Generator, num_feat=64, num_block=23, num_grow_ch=32,
                num_in_ch=3, num_out_ch=3, device="cuda") -> RRDBNet:
    """A random fp32 RRDBNet at the given widths (JAX ``init_esrgan_params``'s
    shapes; torch-default init drawn from ``generator``)."""
    net = materialize(RRDBNet(num_in_ch, num_out_ch, num_feat, num_block, num_grow_ch), device)
    return init_random_(net, generator).eval()


def esrgan_from_state_dict(sd: dict, device="cuda") -> RRDBNet:
    """A Real-ESRGAN ``RRDBNet`` state dict (reference registry hash
    6b7116078c4170bfbeaedc8fe71f6649) -> :class:`RRDBNet` in fp32; the
    widths and depth are read from the tensors."""
    num_block = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("body."))
    first, last = sd["conv_first.weight"], sd["conv_last.weight"]
    net = materialize(RRDBNet(first.shape[1], last.shape[0], first.shape[0], num_block,
                              sd["body.0.rdb1.conv1.weight"].shape[0]), device)
    net.load_state_dict({k: torch.as_tensor(v).float() for k, v in sd.items()})
    return net.eval()


def load_esrgan(path: str, device="cuda") -> RRDBNet:
    """Load a Real-ESRGAN checkpoint file."""
    from physicedit_torch.io.safetensors_io import load_state_dict

    return esrgan_from_state_dict(load_state_dict(path), device)


# ---------------------------------------------------------------------------
# Host wrapper (reference ESRGAN.upscale, ESRGAN/__init__.py:108-137)
# ---------------------------------------------------------------------------

@torch.no_grad()
def upscale(net: RRDBNet, images, batch_size: int = 4):
    """PIL image or list of PIL images -> 4x-upscaled PIL image(s)."""
    from PIL import Image

    single = not isinstance(images, (list, tuple))
    if single:
        images = [images]
    arr = np.stack([np.asarray(im, np.float32) / 255.0 for im in images])
    device = net.conv_first.weight.device
    outs = []
    for i in range(0, arr.shape[0], batch_size):
        out = rrdbnet_forward(net, torch.from_numpy(arr[i:i + batch_size]).to(device))
        # clip, then truncate to uint8 on the device: a quarter of the bytes home
        outs.append((out * 255.0).clamp(0, 255).to(torch.uint8).cpu())
    pil = [Image.fromarray(o) for o in torch.cat(outs).numpy()]
    return pil[0] if single else pil

"""RIFE video frame interpolation (IFNet) (``physicedit_tpu/extensions/rife.py``).

The reference extension (DiffSynth-Studio/diffsynth/extensions/RIFE/
__init__.py:8-242): a 3-scale coarse-to-fine optical-flow network that
makes the midpoint frame of two frames, and the Interpolater / Smoother
host drivers.  IFNet runs in fp32, as the reference pins it.

- The modules carry the JAX parameter tree's names: a conv leaf ``{"w",
  "b", "a"}`` is :class:`ConvPReLU` (a conv with its PReLU slope ``a``), a
  deconv ``nn.ConvTranspose2d(k=4, stride=2, padding=1)``.
- ``F.interpolate(bilinear, align_corners=False, antialias=False)`` resizes
  (no antialias filter even when it downsamples); :func:`warp` is the
  reference's ``grid_sample(bilinear, border, align_corners=True)`` in
  pixel coordinates, as explicit gathers (the JAX package's arithmetic).
- The two flow directions of each IFBlock share its weights, so they run as
  one batch of 2B.

The public :func:`ifnet_forward` keeps the JAX package's NHWC interface;
inside, tensors are NCHW.  The drivers keep the reference's BGR channel
order (``[:, :, [2, 1, 0]]``) and its uint8 truncation; their frames stay
on the network's device from upload to the last iteration.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import materialize


class ConvPReLU(nn.Conv2d):
    """Conv2d(k=3, padding=1) + PReLU, the slope ``a`` per channel."""

    def __init__(self, cin, cout, stride):
        super().__init__(cin, cout, 3, stride=stride, padding=1, device="meta")
        self.a = nn.Parameter(torch.empty(cout, device="meta"))

    def forward(self, x):
        return F.prelu(super().forward(x), self.a)


def _deconv(cin, cout):
    """ConvTranspose2d(k=4, stride=2, padding=1): H -> 2H."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, device="meta")


class _Head(nn.Module):
    """deconv -> PReLU -> deconv (the flow head ``conv1`` and mask head ``conv2``)."""

    def __init__(self, c, cout):
        super().__init__()
        self.deconv1 = _deconv(c, c // 2)
        self.prelu = nn.Parameter(torch.empty(c // 2, device="meta"))
        self.deconv2 = _deconv(c // 2, cout)

    def forward(self, x):
        return self.deconv2(F.prelu(self.deconv1(x), self.prelu))


class IFBlock(nn.Module):
    def __init__(self, in_planes, c):
        super().__init__()
        self.conv0 = nn.ModuleList([ConvPReLU(in_planes, c // 2, 2), ConvPReLU(c // 2, c, 2)])
        for i in range(4):
            self.add_module(f"convblock{i}", nn.ModuleList([ConvPReLU(c, c, 1),
                                                            ConvPReLU(c, c, 1)]))
        self.conv1 = _Head(c, 4)
        self.conv2 = _Head(c, 1)


class IFNet(nn.Module):
    """Built on the ``meta`` device; in_planes = 7 image / mask channels +
    4 flow channels."""

    def __init__(self, c=90, in_planes=11):
        super().__init__()
        self.block0 = IFBlock(in_planes, c)
        self.block1 = IFBlock(in_planes, c)
        self.block2 = IFBlock(in_planes, c)


# ---------------------------------------------------------------------------
# Forward (NCHW)
# ---------------------------------------------------------------------------

def _resize_bilinear(x, out_h: int, out_w: int):
    """torch F.interpolate(mode='bilinear', align_corners=False,
    antialias=False): half-pixel centers, edge clamp, no antialias filter."""
    if tuple(x.shape[2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                         antialias=False)


def warp(img, flow):
    """Backward-warp img [B, C, H, W] by flow [B, 2, H, W] (dx, dy in
    pixels), bilinear, border padding: the reference's normalized-grid
    ``grid_sample(align_corners=True, padding_mode='border')``
    (RIFE/__init__.py:8-23) in pixel coordinates."""
    b, c, h, w = img.shape
    gy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    px = (gx + flow[:, 0].float()).clamp(0.0, w - 1.0)
    py = (gy + flow[:, 1].float()).clamp(0.0, h - 1.0)
    x0, y0 = px.floor(), py.floor()
    tx = (px - x0).to(img.dtype)[:, None]
    ty = (py - y0).to(img.dtype)[:, None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp_max(w - 1), (y0 + 1).clamp_max(h - 1)
    flat = img.reshape(b, c, h * w)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return flat.gather(2, idx).reshape(b, c, h, w)

    top = gather(y0, x0) * (1 - tx) + gather(y0, x1) * tx
    bot = gather(y1, x0) * (1 - tx) + gather(y1, x1) * tx
    return top * (1 - ty) + bot * ty


def _ifblock(p: IFBlock, x, flow, scale: float):
    """IFBlock (RIFE/__init__.py:34-57): downsample by ``scale``, a conv
    encoder (stride 4 in all), 4 residual double convs, two deconv heads.
    ``scale`` may be fractional; sizes floor like F.interpolate."""
    h, w = x.shape[2:]
    hs, ws = int(h / scale), int(w / scale)
    x = _resize_bilinear(x, hs, ws)
    flow = _resize_bilinear(flow, hs, ws) * (1.0 / scale)
    feat = p.conv0[1](p.conv0[0](torch.cat([x, flow], 1)))
    for i in range(4):
        blk = getattr(p, f"convblock{i}")
        feat = blk[1](blk[0](feat)) + feat
    flow_out = _resize_bilinear(p.conv1(feat), h, w) * float(scale)
    mask_out = _resize_bilinear(p.conv2(feat), h, w)
    return flow_out, mask_out


def _swap(flow):
    return torch.cat([flow[:, 2:4], flow[:, :2]], 1)


def ifnet_nchw(net: IFNet, img0, img1, scale_list=(4, 2, 1)):
    """:func:`ifnet_forward` on NCHW tensors: (flow, mask, merged)."""
    b, _, h, w = img0.shape
    flow = img0.new_zeros(b, 4, h, w)
    mask = img0.new_zeros(b, 1, h, w)
    warped0, warped1 = img0, img1
    for i, scale in enumerate(scale_list):
        # both directions through the block's shared weights in one batch
        f, m = _ifblock(getattr(net, f"block{i}"),
                        torch.cat([torch.cat([warped0, warped1, mask], 1),
                                   torch.cat([warped1, warped0, -mask], 1)], 0),
                        torch.cat([flow, _swap(flow)], 0), float(scale))
        f0, f1 = f[:b], f[b:]
        m0, m1 = m[:b], m[b:]
        flow = flow + (f0 + _swap(f1)) * 0.5
        mask = mask + (m0 - m1) * 0.5
        warped0 = warp(img0, flow[:, :2])
        warped1 = warp(img1, flow[:, 2:4])
    sig = torch.sigmoid(mask)
    return flow, sig, warped0 * sig + warped1 * (1 - sig)


@torch.no_grad()
def ifnet_forward(net: IFNet, img0, img1, scale_list=(4, 2, 1)):
    """Midpoint-frame inference (RIFE/__init__.py:68-100, training=False).

    img0 / img1: [B, H, W, 3] in [0, 1] (H, W divisible by 32 x the largest
    scale; the host drivers round up).  Returns (flow, mask, merged), NHWC.
    """
    def nchw(t):
        return t.permute(0, 3, 1, 2)

    return tuple(t.permute(0, 2, 3, 1)
                 for t in ifnet_nchw(net, nchw(img0), nchw(img1), scale_list))


# ---------------------------------------------------------------------------
# Init / loading
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_ifnet(generator: torch.Generator, c=90, in_planes=11, device="cuda") -> IFNet:
    """A random fp32 IFNet with JAX ``init_ifnet_params``' distribution:
    conv and deconv kernels normal x 0.05, biases 0, PReLU slopes 0.25."""
    net = materialize(IFNet(c, in_planes), device)
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.normal_(0.0, 0.05, generator=generator)
            m.bias.zero_()
    for name, p in net.named_parameters():
        if name.endswith(".a") or name.endswith(".prelu"):
            p.fill_(0.25)
    return net.eval()


def _key_map(net: IFNet) -> dict:
    """Port parameter -> reference key (``block{i}.conv0.{j}.0.weight``, a
    conv's PReLU at ``.1.weight``, a head's deconvs at ``.0`` / ``.2``)."""
    out = {}
    for name, _ in net.named_parameters():
        parts = name.split(".")
        if parts[1] in ("conv1", "conv2"):
            sub = {"deconv1": "0", "prelu": "1", "deconv2": "2"}[parts[2]]
            ref = parts[:2] + [sub] + (parts[3:] if parts[2] != "prelu" else ["weight"])
        else:       # conv0.{j} / convblock{k}.{j} . weight | bias | a
            ref = parts[:3] + (["1", "weight"] if parts[3] == "a" else ["0", parts[3]])
        out[name] = ".".join(ref)
    return out


def ifnet_from_state_dict(sd: dict, device="cuda") -> IFNet:
    """The reference IFNet checkpoint (keys ``block{i}.conv....``, with or
    without ``module.`` prefixes; the training-only ``block_tea`` is not
    read) -> :class:`IFNet` in fp32; ``c`` is read from the tensors."""
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    net = materialize(IFNet(sd["block0.conv0.1.0.weight"].shape[0],      # [c, c/2, 3, 3]
                            sd["block0.conv0.0.0.weight"].shape[1]), device)
    net.load_state_dict({name: torch.as_tensor(sd[ref]).float().reshape(p.shape)
                         for (name, ref), p in zip(_key_map(net).items(), net.parameters())})
    return net.eval()


def ifnet_to_state_dict(net: IFNet) -> dict:
    """The reference-layout state dict of ``net`` (the inverse of
    :func:`ifnet_from_state_dict`; no ``block_tea``)."""
    params = dict(net.named_parameters())
    return {ref: params[name].detach() for name, ref in _key_map(net).items()}


def load_rife(path: str, device="cuda") -> IFNet:
    """Load a RIFE flownet checkpoint file."""
    from physicedit_torch.io.safetensors_io import load_state_dict

    return ifnet_from_state_dict(load_state_dict(path), device)


# ---------------------------------------------------------------------------
# Host drivers (reference RIFEInterpolater / RIFESmoother)
# ---------------------------------------------------------------------------

def _process_images(images):
    """PIL -> [N, H, W, 3] BGR float in [0,1], rounded UP to /32 sizes.

    Keeps the reference's BGR channel flip (RIFE/__init__.py:130-137).  As
    in the JAX package, a size that is not a multiple of 32 rounds up to
    the next multiple (the reference's branch resizes to ``(w+31)//32``
    pixels, processors/RIFE.py:25-29, which plainly meant that)."""
    out = []
    for image in images:
        width, height = image.size
        if width % 32 or height % 32:
            image = image.resize(((width + 31) // 32 * 32, (height + 31) // 32 * 32))
        out.append(np.asarray(image, np.float32)[:, :, [2, 1, 0]] / 255.0)
    return np.stack(out)


def _decode_images(arr, size=None):
    """[N, H, W, 3] BGR in [0, 1] -> PIL (uint8 by truncation after the clip)."""
    from PIL import Image

    arr = np.clip(arr[:, :, :, [2, 1, 0]] * 255.0, 0, 255).astype(np.uint8)
    images = [Image.fromarray(a) for a in arr]
    if size is not None and images and images[0].size != size:
        images = [im.resize(size) for im in images]
    return images


class RIFEInterpolater:
    """Doubles the frame rate ``num_iter`` times (RIFE/__init__.py:119-197)."""

    def __init__(self, net: IFNet):
        self.net = net

    def _upload(self, images):
        frames = torch.from_numpy(_process_images(images)).permute(0, 3, 1, 2)
        return frames.to(self.net.block0.conv1.prelu.device).contiguous()

    @staticmethod
    def _download(frames, size):
        return _decode_images(frames.permute(0, 2, 3, 1).cpu().numpy(), size)

    def _merged(self, a, b, scale):
        scale_list = tuple(float(s) / scale for s in (4, 2, 1))
        return ifnet_nchw(self.net, a, b, scale_list)[2]

    @torch.no_grad()
    def _midpoints(self, frames, scale=1.0, batch_size=4):
        outs = []
        for i in range(0, frames.shape[0] - 1, batch_size):
            img0 = frames[i:i + batch_size]
            img1 = frames[i + 1:i + 1 + batch_size]
            n = min(img0.shape[0], img1.shape[0])
            outs.append(self._merged(img0[:n], img1[:n], scale))
        return torch.cat(outs).clamp(0.0, 1.0)

    @torch.no_grad()
    def interpolate(self, images, scale=1.0, batch_size=4, num_iter=1,
                    progress_bar=lambda x: x):
        size = images[0].size
        frames = self._upload(images)
        for _ in range(num_iter):
            mid = self._midpoints(frames, scale, batch_size)
            inter = frames.new_empty((frames.shape[0] + mid.shape[0],) + frames.shape[1:])
            inter[0::2] = frames
            inter[1::2] = mid
            frames = inter
        return self._download(frames, size)


class RIFESmoother(RIFEInterpolater):
    """Deflickers a rendered frame sequence (RIFE/__init__.py:200-242):
    interpolate frame i's neighbours (i-1, i+1), then blend with frame i."""

    def _pair(self, a, b, scale, batch_size):
        return torch.cat([self._merged(a[i:i + batch_size], b[i:i + batch_size], scale)
                          for i in range(0, a.shape[0], batch_size)])

    @torch.no_grad()
    def __call__(self, rendered_frames, scale=1.0, batch_size=4, num_iter=1, **kwargs):
        size = rendered_frames[0].size
        frames = self._upload(rendered_frames)
        for _ in range(num_iter):
            mid = self._pair(frames[:-2], frames[2:], scale, batch_size)
            frames[1:-1] = self._pair(frames[1:-1], mid, scale, batch_size)
        return self._download(frames, size)

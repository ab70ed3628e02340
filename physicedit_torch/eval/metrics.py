"""Image-quality metrics for parity scoring (``physicedit_tpu/eval/metrics.py``):
PSNR and SSIM in NumPy, and LPIPS when the ``lpips`` package (and its VGG
weights) can be imported, else None."""

from __future__ import annotations

import numpy as np


def to_float(img) -> np.ndarray:
    """PIL image or uint8/float array -> float32 [H, W, C] in [0, 1]."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return arr.astype(np.float32)


def psnr(a, b, data_range: float = 1.0) -> float:
    a, b = to_float(a), to_float(b)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-0.5 * (x / sigma) ** 2)
    k = np.outer(g, g)
    return k / k.sum()


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Valid-mode 2-D convolution per channel (small kernels)."""
    kh, kw = kernel.shape
    h, w = img.shape[:2]
    out_h, out_w = h - kh + 1, w - kw + 1
    strides = img.strides[:2] + img.strides[:2] + img.strides[2:]
    shape = (out_h, out_w, kh, kw) + img.shape[2:]
    windows = np.lib.stride_tricks.as_strided(img, shape=shape, strides=strides)
    return np.einsum("ijklc,kl->ijc", windows, kernel)


def ssim(a, b, data_range: float = 1.0, size: int = 11, sigma: float = 1.5) -> float:
    """Mean structural similarity (Wang et al. 2004 constants)."""
    a, b = to_float(a), to_float(b)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = _gaussian_kernel(size, sigma)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2(a * a, k) - mu_aa
    s_bb = _filter2(b * b, k) - mu_bb
    s_ab = _filter2(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return float(np.mean(num / den))


def lpips(a, b) -> float | None:
    """LPIPS distance when the ``lpips`` package is importable, else None
    (it needs downloaded VGG weights; callers fall back to PSNR / SSIM)."""
    try:
        import lpips as lpips_lib
        import torch
    except ImportError:
        return None
    net = lpips_lib.LPIPS(net="vgg")

    def prep(x):
        t = torch.tensor(to_float(x)).permute(2, 0, 1)[None]
        return t * 2 - 1

    with torch.no_grad():
        return float(net(prep(a), prep(b)))


def parity_report(ours, reference) -> dict:
    """Every available metric between two images."""
    report = {"psnr": psnr(ours, reference), "ssim": ssim(ours, reference)}
    d = lpips(ours, reference)
    if d is not None:
        report["lpips"] = d
    return report

"""``kernels/qk_norm_rope``'s plain version on the CPU: against the JAX
block's q / k RMSNorm, RoPE and text-first concatenate on the same inputs,
where each stream's rows land, and the DiT, whose blocks call the wrapper,
which runs the plain version with grad on.  The CUDA kernel is held to the
plain version on the card (``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicedit_tpu.ops import norms as j_norms
from physicedit_tpu.ops import rope as j_rope

from physicedit_torch.core.params import init_random_, materialize
from physicedit_torch.kernels import qk_norm_rope as qkr
from physicedit_torch.models import dit as t_dit
from physicedit_torch.ops.rope import build_rope_tables

torch.set_num_threads(2)

# the same ops on the same inputs: bf16 bit for bit; fp32 within XLA's own
# rounding of the norm and the rotation (3.8e-6 at most, of values up to ~20)
TOL = {torch.float32: dict(atol=1e-5, rtol=0), torch.bfloat16: dict(atol=0, rtol=0)}

# name: batch, heads (a TP slice's share when below 24), text rows, image
# rows (two images of h x w tokens), slim_base, text tables per batch row
CASES = {
    "full_block": (2, 24, 40, (4, 8), 0, False),
    "slim_block": (2, 24, 40, (4, 8), 32, False),
    "per_row_text_tables": (2, 24, 40, (4, 8), 0, True),
    "tp_slice": (2, 6, 40, (4, 8), 0, False),
    "text_not_a_multiple_of_64": (2, 24, 37, (4, 8), 32, True),
}


def _inputs(case, dtype, head_dim=128, seed=0):
    b, n, s_t, (h, w), slim_base, per_row = CASES[case]
    g = torch.Generator().manual_seed(seed)
    s_i = 2 * h * w
    img_qkv = (2.0 * torch.randn(b, s_i, 3 * n * head_dim, generator=g)).to(dtype)
    txt_qkv = (2.0 * torch.randn(b, s_t, 3 * n * head_dim, generator=g)).to(dtype)
    gains = [(1.0 + 0.3 * torch.randn(head_dim, generator=g)).to(dtype) for _ in range(4)]
    gains[3] = torch.full((head_dim,), 4.0, dtype=dtype)   # the text keys, as in pebench
    axes = (16, 56, 56) if head_dim == 128 else (8, 12, 12)
    img_cos, img_sin, txt_cos, txt_sin = (torch.from_numpy(t) for t in build_rope_tables(
        [(1, h, w), (1, h, w)], s_t, axes_dim=axes))
    if per_row:   # EliGen's text tables, one per CFG row: here shifted by a row's offset
        txt_cos = torch.stack([txt_cos.roll(r, 0) for r in range(b)])[:, None]
        txt_sin = torch.stack([txt_sin.roll(r, 0) for r in range(b)])[:, None]
    return (img_qkv, txt_qkv, tuple(gains), img_cos, img_sin, txt_cos, txt_sin), slim_base


def _jax_joint_qkv(args, eps, slim_base):
    """The JAX block's q, k, v (``physicedit_tpu/models/dit.py``): each
    stream's ``apply_rope(rms_norm(.))``, the text-first concatenate, the
    slim block's query rows."""
    img_qkv, txt_qkv, gains, img_cos, img_sin, txt_cos, txt_sin = (
        jax.tree_util.tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), a) for a in args)
    b, s_i, width = img_qkv.shape
    s_t, hd = txt_qkv.shape[1], gains[0].shape[-1]
    n = width // (3 * hd)
    iq, ik, iv = img_qkv.reshape(b, s_i, 3, n, hd).transpose(2, 0, 3, 1, 4)
    tq, tk, tv = txt_qkv.reshape(b, s_t, 3, n, hd).transpose(2, 0, 3, 1, 4)
    iq, ik = (j_rope.apply_rope(j_norms.rms_norm(x, g, eps), img_cos, img_sin)
              for x, g in ((iq, gains[0]), (ik, gains[1])))
    tq, tk = (j_rope.apply_rope(j_norms.rms_norm(x, g, eps), txt_cos, txt_sin)
              for x, g in ((tq, gains[2]), (tk, gains[3])))
    q, k, v = (jnp.concatenate(pair, axis=2) for pair in ((tq, iq), (tk, ik), (tv, iv)))
    if slim_base:
        q = q[:, :, s_t:s_t + slim_base]
    return [np.asarray(t.astype(jnp.float32)) for t in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_jax_block(case, dtype):
    """The plain version (what ``qk_norm_rope`` runs on the CPU, and the
    DiT with grad on) against the JAX block's own ops on the same inputs."""
    args, slim_base = _inputs(case, dtype)
    got = qkr.qk_norm_rope(*args, 1e-6, slim_base)
    want = _jax_joint_qkv(args, 1e-6, slim_base)
    b, n, s_t, (h, w) = CASES[case][:4]
    s = s_t + 2 * h * w
    assert [tuple(t.shape) for t in got] == [(b, n, slim_base or s, 128), (b, n, s, 128),
                                             (b, n, s, 128)]
    for name, x, y in zip("qkv", got, want):
        assert x.dtype == dtype and x.is_contiguous(), name
        np.testing.assert_allclose(x.float().numpy(), y, **TOL[dtype], err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_places_each_stream(case):
    """Where the rows land: text first on k's and v's joint axis, then the
    image, in every head; the slim block's q the full q's first image rows
    alone; a stream's rows depend on that stream alone."""
    args, slim_base = _inputs(case, torch.float32)
    img_qkv, txt_qkv = args[:2]
    b, n, s_t = CASES[case][:3]
    hd = 128
    q, k, v = qkr.qk_norm_rope(*args, 1e-6, 0)
    heads = lambda x, which: x.view(b, x.shape[1], 3, n, hd)[:, :, which].transpose(1, 2)  # noqa: E731
    assert torch.equal(v[:, :, :s_t], heads(txt_qkv, 2))
    assert torch.equal(v[:, :, s_t:], heads(img_qkv, 2))
    if slim_base:
        slim_q, slim_k, slim_v = qkr.qk_norm_rope(*args, 1e-6, slim_base)
        assert torch.equal(slim_q, q[:, :, s_t:s_t + slim_base])
        assert torch.equal(slim_k, k) and torch.equal(slim_v, v)
    q2, k2, _ = qkr.qk_norm_rope(img_qkv + 1.0, *args[1:], 1e-6, 0)
    assert torch.equal(q2[:, :, :s_t], q[:, :, :s_t]) and torch.equal(k2[:, :, :s_t], k[:, :, :s_t])
    assert not torch.equal(k2[:, :, s_t:], k[:, :, s_t:])


def test_plain_version_refuses_mismatched_streams():
    args, _ = _inputs("full_block", torch.float32)
    with pytest.raises(ValueError, match="3 N 128"):
        qkr.qk_norm_rope(args[0][..., :-128], *args[1:])
    with pytest.raises(ValueError, match="one B and N"):
        qkr.qk_norm_rope(args[0], args[1][:1], *args[2:])


def _tiny_dit(dtype, seed=0):
    cfg = t_dit.DiTConfig(num_layers=2, dim=256, num_heads=2, head_dim=128, txt_in_dim=96,
                          patch_dim=64, time_dim=64)
    dit = init_random_(materialize(t_dit.DiT(cfg, dtype), "cpu"),
                       torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():
        dit.blocks[0].attn["norm_added_k"].scale.fill_(4.0)
    return dit


@pytest.mark.parametrize("per_row", [False, True], ids=["shared_text_tables",
                                                        "per_row_text_tables"])
@pytest.mark.parametrize("slim", [0, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_dit_forward_without_grad_equals_the_eager_forward(dtype, slim, per_row, monkeypatch):
    """The DiT with grad off gives the bits of the same forward with grad on
    (the wrapper's plain version, the eager ops), the slim last block
    included; every block calls ``qk_norm_rope`` under both."""
    dit = _tiny_dit(dtype)
    rng = np.random.default_rng(1)
    b, s_t, h, w = 2, 24, 4, 4
    img = torch.from_numpy(rng.normal(size=(b, 2 * h * w, 64)).astype(np.float32)).to(dtype)
    txt = torch.from_numpy(rng.normal(size=(b, s_t, 96)).astype(np.float32)).to(dtype)
    t = torch.tensor([0.7, 0.7], dtype=dtype)
    mask = torch.ones(b, s_t, dtype=torch.bool)
    mask[1, 16:] = False
    ropes = [torch.from_numpy(r) for r in build_rope_tables([(1, h, w), (1, h, w)], s_t)]
    if per_row:
        ropes[2:] = [torch.stack([r, r.roll(1, 0)])[:, None] for r in ropes[2:]]
    calls = []
    real = t_dit.qk_norm_rope
    monkeypatch.setattr(t_dit, "qk_norm_rope", lambda *a: calls.append(1) or real(*a))

    def forward():
        return dit(img, txt, t, *ropes, txt_key_mask=mask, slim_last=slim, attn_clamp=True)

    with torch.no_grad():
        fused = forward()
    assert len(calls) == 2
    with torch.enable_grad():
        eager = forward()
    assert len(calls) == 4
    assert fused.shape == (b, slim or 2 * h * w, 64)
    assert torch.equal(fused, eager)

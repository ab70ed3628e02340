"""``kernels/ln_mod``: the bf16 modulated LayerNorm and the gated residual
in front of it.

On the CPU: the plain versions (what the wrappers run on CPU tensors and
with grad on) against today's eager formulas, written out here; the DiT
block, the FLUX single block and both DiTs, grad on and grad off, against
the same forward with those formulas in place of the wrappers, bit for bit,
with the wrappers' calls counted and no launch; and the calls one bf16 edit
makes, as ``chip_smoke.py`` demands them.  On the card (skipped without
one): the kernel against its plain versions, and with grad on the plain
versions' bits and gradients with no launch; the launches of a grad-off
forward, none under grad nor on the W4 fused path, and the inputs it
refuses.  The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_ln_mod.py -q
"""

import numpy as np
import pytest
import torch
from PIL import Image

from physicedit_torch.core.params import init_random_, materialize
from physicedit_torch.kernels import ln_mod as lm
from physicedit_torch.models import dit as t_dit
from physicedit_torch.models import flux as t_flux
from physicedit_torch.ops.rope import build_rope_tables, flux_rope_tables

torch.set_num_threads(2)

EPS = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def old_modulate(x, shift, scale, eps):
    """The modulated LayerNorm in eager ops, ``ops.norms.layer_norm``
    written out: fp32 mean and population variance, the result cast to x's
    dtype before the affine."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    ln = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return ln * (1.0 + scale[:, None, :]) + shift[:, None, :]


def old_residual(x, o, gate):
    """A block's first gated residual in eager ops."""
    return x + gate[:, None, :] * o


def old_residual_ln_mod(x, o, gate, shift, scale, eps):
    """The first gated residual, then ``old_modulate`` of its result."""
    x = old_residual(x, o, gate)
    return x, old_modulate(x, shift, scale, eps)


def _operands(b, s, d, whole, dtype, device="cpu", seed=0):
    """x (the first ``s`` rows of ``whole`` when ``whole``), o, and shift,
    scale and gate as ``chunk`` views of a [B, 6 D] modulation output."""
    g = torch.Generator(device).manual_seed(seed)
    rows = whole or s
    x = (2.0 * torch.randn(b, rows, d, generator=g, device=device)
         + 0.5 * torch.randn(b, rows, 1, generator=g, device=device)).to(dtype)[:, :s]
    o = torch.randn(b, s, d, generator=g, device=device).to(dtype)
    mod = (0.5 * torch.randn(b, 6 * d, generator=g, device=device)).to(dtype)
    _, _, gate, shift, scale, _ = mod.chunk(6, -1)
    return x, o, shift, scale, gate


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("whole", [0, 40], ids=["whole_x", "row_strided_x"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("entry", ["ln_mod", "residual_ln_mod"])
def test_plain_versions_equal_the_eager_formulas(entry, b, whole, dtype):
    """Both entry points on CPU tensors (their plain versions) give today's
    eager formulas bit for bit, on a whole x and on the slim block's
    row-strided view, with shift, scale and gate ``chunk`` views; the
    outputs are contiguous and no kernel launch is counted."""
    x, o, shift, scale, gate = _operands(b, 24, 256, whole, dtype)
    assert x.stride() == ((whole or 24) * 256, 256, 1)
    before = dict(lm.LAUNCHES)
    if entry == "ln_mod":
        got = [lm.ln_mod(x, shift, scale, EPS), lm.ln_mod_reference(x, shift, scale, EPS)]
        want = old_modulate(x, shift, scale, EPS)
        for y in got:
            assert y.dtype == dtype and y.is_contiguous() and torch.equal(y, want)
    else:
        got = [lm.residual_ln_mod(x, o, gate, shift, scale, EPS),
               lm.residual_ln_mod_reference(x, o, gate, shift, scale, EPS)]
        want_x = old_residual(x, o, gate)
        want_y = old_modulate(want_x, shift, scale, EPS)
        for x_out, y in got:
            assert x_out.is_contiguous() and y.is_contiguous()
            assert torch.equal(x_out, want_x) and torch.equal(y, want_y)
    assert lm.LAUNCHES == before


def _tiny_qwen_dit(dtype, device="cpu"):
    cfg = t_dit.DiTConfig(num_layers=2, dim=256, num_heads=2, head_dim=128, txt_in_dim=96,
                          patch_dim=64, time_dim=64)
    dit = init_random_(materialize(t_dit.DiT(cfg, dtype), device),
                       torch.Generator(device).manual_seed(0)).eval()
    with torch.no_grad():
        dit.blocks[0].attn["norm_added_k"].scale.fill_(4.0)
    return dit


def _tiny_flux_dit(dtype, device="cpu"):
    cfg = t_flux.FluxConfig(num_layers=1, num_single_layers=1, dim=256, num_heads=2,
                            head_dim=128, txt_in_dim=64, pooled_dim=32, patch_dim=64,
                            time_dim=64)
    return init_random_(materialize(t_flux.FluxDiT(cfg, dtype), device),
                        torch.Generator(device).manual_seed(0)).eval()


S_T, GRID = 24, (4, 4)   # text rows; each of the two images' token grid
BASE = GRID[0] * GRID[1]


def _qwen_forward(dtype, slim, device="cpu"):
    dit = _tiny_qwen_dit(dtype, device)
    g = torch.Generator(device).manual_seed(1)
    img = torch.randn(2, 2 * BASE, 64, generator=g, device=device).to(dtype)
    txt = torch.randn(2, S_T, 96, generator=g, device=device).to(dtype)
    t = torch.tensor([0.7, 0.7], device=device).to(dtype)
    mask = torch.ones(2, S_T, dtype=torch.bool, device=device)
    mask[1, 16:] = False
    ropes = [torch.from_numpy(r).to(device)
             for r in build_rope_tables([(1, *GRID), (1, *GRID)], S_T)]
    return lambda: dit(img, txt, t, *ropes, txt_key_mask=mask, slim_last=slim, attn_clamp=True)


def _flux_forward(dtype, slim, device="cpu"):
    dit = _tiny_flux_dit(dtype, device)
    g = torch.Generator(device).manual_seed(1)
    img = torch.randn(2, 2 * BASE, 64, generator=g, device=device).to(dtype)
    txt = torch.randn(2, S_T, 64, generator=g, device=device).to(dtype)
    t = torch.tensor([0.7, 0.4], device=device).to(dtype)
    guidance = torch.tensor([2.5, 2.5], device=device).to(dtype)
    pooled = torch.randn(2, 32, generator=g, device=device).to(dtype)
    ropes = [r.to(device) for r in (torch.from_numpy(a) for a in flux_rope_tables(
        [(1, *GRID), (1, *GRID)], S_T))]
    return lambda: dit(img, txt, t, *ropes, slim_last=slim, guidance=guidance, pooled=pooled,
                       attn_clamp=True)


def _block_forward(kind, dtype, slim, device="cpu"):
    """One block of a tiny DiT on its own: ``DiTBlock`` (Qwen-Image's) or
    ``FluxSingleBlock``, on drawn activations."""
    g = torch.Generator(device).manual_seed(2)
    temb = torch.randn(2, 256, generator=g, device=device).to(dtype)
    img = torch.randn(2, 2 * BASE, 256, generator=g, device=device).to(dtype)
    txt = torch.randn(2, S_T, 256, generator=g, device=device).to(dtype)
    if kind == "dit_block":
        block = _tiny_qwen_dit(dtype, device).blocks[0]
        ropes = [torch.from_numpy(r).to(device)
                 for r in build_rope_tables([(1, *GRID), (1, *GRID)], S_T)]
        return lambda: block(img, txt, temb, *ropes, None, slim_base=slim)[1]
    block = _tiny_flux_dit(dtype, device).single_blocks[0]
    ropes = [torch.from_numpy(r).to(device)
             for r in flux_rope_tables([(1, *GRID), (1, *GRID)], S_T)]
    x = torch.cat([txt, img], dim=1)
    return lambda: block(x, S_T, temb, *ropes, slim_base=slim)


# model: (a function making its forward, the grad-off calls of ln_mod and
# of residual_ln_mod).  A full DiTBlock: ln_mod for both streams' QKV inputs,
# residual_ln_mod for both streams' MLP inputs; the slim one the image
# stream's MLP alone; a single block one ln_mod; each DiT one more, its
# final layer
FORWARDS = {
    "dit_block": (lambda dt, dev: _block_forward("dit_block", dt, 0, dev), (2, 2)),
    "dit_block_slim": (lambda dt, dev: _block_forward("dit_block", dt, BASE, dev), (2, 1)),
    "flux_single_block": (lambda dt, dev: _block_forward("single", dt, 0, dev), (1, 0)),
    "flux_single_block_slim": (lambda dt, dev: _block_forward("single", dt, BASE, dev), (1, 0)),
    "qwen_dit": (lambda dt, dev: _qwen_forward(dt, 0, dev), (5, 4)),
    "qwen_dit_slim": (lambda dt, dev: _qwen_forward(dt, BASE, dev), (5, 3)),
    "flux_dit": (lambda dt, dev: _flux_forward(dt, 0, dev), (4, 2)),
    "flux_dit_slim": (lambda dt, dev: _flux_forward(dt, BASE, dev), (4, 2)),
}


# the wrappers as the models import them
WRAPPERS = ((t_dit, "ln_mod"), (t_dit, "residual_ln_mod"), (t_flux, "ln_mod"))


def _spy(monkeypatch, calls):
    for module, name in WRAPPERS:
        real = getattr(module, name)

        def counted(*a, real=real, name=name):
            calls[name] += 1
            return real(*a)

        monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("grad", [False, True], ids=["grad_off", "grad_on"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("model", list(FORWARDS))
def test_forwards_equal_todays_code(model, dtype, grad, monkeypatch):
    """A block or a DiT forward on the CPU, grad on or off, gives the bits of
    the same forward with the eager formulas (``old_modulate``, and the
    gated residual followed by it) in place of the wrappers.  Either way it
    reaches the wrappers (their plain versions here) as often as the card
    would launch the kernels with grad off, and no launch is counted."""
    build, want_calls = FORWARDS[model]
    forward = build(dtype, "cpu")
    with monkeypatch.context() as m:
        for module, name in WRAPPERS:
            m.setattr(module, name,
                      old_residual_ln_mod if name == "residual_ln_mod" else old_modulate)
        with torch.enable_grad():
            want = forward()
    calls = dict.fromkeys(("ln_mod", "residual_ln_mod"), 0)
    _spy(monkeypatch, calls)
    before = dict(lm.LAUNCHES)
    with torch.set_grad_enabled(grad):
        got = forward()
    assert tuple(calls.values()) == want_calls
    assert lm.LAUNCHES == before
    assert got.dtype == dtype and torch.equal(got, want)


def test_bf16_edit_calls(monkeypatch):
    """The wrappers' calls in one edit (CFG, two steps, the slim last block
    on) are the launches ``chip_smoke.py`` demands of a bf16 edit on the
    card (``ln_mod_launch_counts``), counted here at their call sites."""
    import chip_smoke
    from physicedit_torch.pipeline.testing import build_random_pipeline

    pipe = build_random_pipeline("tiny", device="cpu", generator=torch.Generator().manual_seed(0))
    calls = dict.fromkeys(("ln_mod", "residual_ln_mod"), 0)
    _spy(monkeypatch, calls)
    edit = Image.fromarray(np.random.default_rng(11).integers(0, 255, (64, 64, 3),
                                                              dtype=np.uint8))
    pipe("tilt the cup", edit_image=edit, height=64, width=64, seed=2, num_inference_steps=2,
         cfg_scale=4.0, have_text_reasoning=False, edit_image_auto_resize=False)
    assert calls == chip_smoke.ln_mod_launch_counts(2, pipe.dit.cfg.num_layers)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["image_2x8192x3072", "text_2x640x3072",
                                  "single_1x8704x3072", "slim_view_2x4096_of_8192x3072",
                                  "small_3x37x256"])
def test_kernel_matches_the_plain_versions_on_cuda(cuda, case):
    """Both entry points against their plain versions on the card
    (``chip_smoke.LN_CASES``): x' bit for bit; y bit for bit but where the
    statistics' order moves a LayerNorm value across a bf16 rounding edge,
    each such element the plain version's affine of that value one bf16 ulp
    up or down, at most LN_APART_MAX of them (``ln_mod_agreement``); one
    launch a call with grad off, and a second call bit for bit.  With grad
    on no launch, and the plain versions' bits and gradients."""
    from chip_smoke import ln_mod_agreement, ln_mod_inputs

    x, o, (shift, scale, gate) = ln_mod_inputs(case, cuda, torch.Generator(cuda).manual_seed(5))
    before = dict(lm.LAUNCHES)
    with torch.no_grad():
        y = lm.ln_mod(x, shift, scale, EPS)
        x_out, y_res = lm.residual_ln_mod(x, o, gate, shift, scale, EPS)
    launched = {"ln_mod": before["ln_mod"] + 1, "residual_ln_mod": before["residual_ln_mod"] + 1}
    assert lm.LAUNCHES == launched
    want_x, _ = lm.residual_ln_mod_reference(x, o, gate, shift, scale, EPS)
    assert y.shape == x.shape and y.is_contiguous() and torch.equal(x_out, want_x)
    for got, ln_in in ((y, x), (y_res, want_x)):
        agree = ln_mod_agreement(got, ln_in, shift, scale)
        assert agree["elements_explained"], agree
    with torch.no_grad():
        assert torch.equal(y, lm.ln_mod(x, shift, scale, EPS))
        assert all(map(torch.equal, (x_out, y_res), lm.residual_ln_mod(x, o, gate, shift, scale,
                                                                        EPS)))
    launched = {name: n + 1 for name, n in launched.items()}

    g = torch.Generator(cuda).manual_seed(6)
    for fn, plain in ((lm.ln_mod, lm.ln_mod_reference),
                      (lm.residual_ln_mod, lm.residual_ln_mod_reference)):
        operands = (x, shift, scale) if fn is lm.ln_mod else (x, o, gate, shift, scale)
        mine, ref = ([t.detach().clone().requires_grad_() for t in operands] for _ in range(2))
        with torch.enable_grad():
            got, want = fn(*mine, EPS), plain(*ref, EPS)
            got, want = ((t,) if fn is lm.ln_mod else t for t in (got, want))
            cot = [torch.randn(t.shape, device=cuda, generator=g).bfloat16() for t in want]
            grads = [torch.autograd.grad(out, leaves, cot) for out, leaves in ((got, mine),
                                                                                (want, ref))]
        assert all(map(torch.equal, got, want)) and all(map(torch.equal, *grads))
    assert lm.LAUNCHES == launched


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["qwen_dit", "qwen_dit_slim", "flux_dit", "flux_dit_slim"])
def test_launches_of_a_forward_on_cuda(cuda, model):
    """A grad-off bf16 forward of a 2-block Qwen-Image DiT or a 1 + 1-block
    FLUX DiT launches each kernel as often as the CPU forward calls its
    wrapper (``FORWARDS``); under grad none; the two forwards agree within
    bf16 rounding."""
    build, (n_ln, n_res) = FORWARDS[model]
    forward = build(torch.bfloat16, cuda)
    lm.reset_launch_counts()
    with torch.no_grad():
        fused = forward()
    assert lm.LAUNCHES == {"ln_mod": n_ln, "residual_ln_mod": n_res}
    with torch.enable_grad():
        eager = forward()
    assert lm.LAUNCHES == {"ln_mod": n_ln, "residual_ln_mod": n_res}
    rel = ((fused.float() - eager.float()).norm() / eager.float().norm()).item()
    assert fused.shape == eager.shape and rel < 1e-2


@pytest.mark.cuda
def test_w4_fused_path_launches_no_residual_on_cuda(cuda):
    """The W4 lane's fused blocks keep K4 and their eager gated residuals:
    a grad-off forward of the 2-block DiT packed int4 launches one
    ``ln_mod`` (the final layer) and no ``residual_ln_mod``."""
    from physicedit_torch.kernels import fused_quant as tfq
    from physicedit_torch.kernels.quant_matmul import DIT_OUTER_KEYS, quantize_module_int4

    dit = quantize_module_int4(_tiny_qwen_dit(torch.bfloat16, cuda), skip_top=DIT_OUTER_KEYS)
    g = torch.Generator(cuda).manual_seed(1)
    img = torch.randn(2, 2 * 64, 64, generator=g, device=cuda).bfloat16()
    txt = torch.randn(2, 128, 96, generator=g, device=cuda).bfloat16()
    t = torch.tensor([0.7, 0.7], device=cuda).bfloat16()
    ropes = [torch.from_numpy(r).to(cuda) for r in build_rope_tables([(1, 8, 8), (1, 8, 8)], 128)]
    lm.reset_launch_counts()
    tfq.reset_launch_counts()
    with torch.no_grad():
        dit(img, txt, t, *ropes, slim_last=64)
    assert tfq.LAUNCHES["ln_mod_quant"] > 0
    assert lm.LAUNCHES == {"ln_mod": 1, "residual_ln_mod": 0}


@pytest.mark.cuda
def test_ln_mod_raises_on_unsupported_inputs(cuda):
    """fp32, a width that is not a multiple of 256 (or past 3072) and a CPU
    shift beside CUDA inputs are refused; no eager path stands in."""
    x, o, shift, scale, gate = _operands(2, 24, 512, 0, torch.bfloat16, cuda)
    before = dict(lm.LAUNCHES)
    with torch.no_grad():
        with pytest.raises(ValueError, match="bfloat16"):
            lm.ln_mod(x.float(), shift.float(), scale.float())
        with pytest.raises(ValueError, match="bfloat16"):
            lm.residual_ln_mod(x.float(), o.float(), gate.float(), shift.float(), scale.float())
        with pytest.raises(ValueError, match="width 384"):
            lm.ln_mod(x[..., :384], shift[:, :384], scale[:, :384])
        wide = torch.zeros(2, 4, 3328, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="width 3328"):
            lm.ln_mod(wide, wide[:, 0], wide[:, 0])
        with pytest.raises(ValueError, match="shift"):
            lm.ln_mod(x, shift.cpu(), scale)
    assert lm.LAUNCHES == before

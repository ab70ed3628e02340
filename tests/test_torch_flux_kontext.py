"""The FLUX.1 Kontext [dev] path of ``physicedit_torch`` (``models/flux.py``,
``io/convert.flux_key_map``, ``ops.rope.flux_rope_tables``,
``sampling.flow_match.flux_schedule``, ``pipeline/kontext_pipeline.py``)
against the plain fp32 reference ``tests/flux_reference.py`` (diffusers'
equations, diffusers' key space) on seeded random weights, at a tiny size:
2 + 2 blocks, 2 heads of 128, 16 text rows, a target and a context image of
4 x 4 packed tokens.  The card tests hold the q / k kernel's joint-QKV mode
(the single-stream blocks' launch) to its plain version."""

import math

import numpy as np
import pytest
import torch

from physicedit_torch.io import convert as C
from physicedit_torch.kernels import qk_norm_rope as tqk
from physicedit_torch.models import dit as t_dit
from physicedit_torch.models.flux import FluxConfig, FluxDiT
from physicedit_torch.ops.rope import flux_rope_tables
from physicedit_torch.pipeline.kontext_pipeline import FluxKontextPipeline
from physicedit_torch.sampling import flow_match as fm
import flux_reference as ref

torch.set_num_threads(2)

CFG = FluxConfig(num_layers=2, num_single_layers=2, dim=256, num_heads=2, head_dim=128,
                 txt_in_dim=64, pooled_dim=32, patch_dim=64, time_dim=256)
S_T, GRID = 16, (4, 4)          # text rows; the target's and the context's token grid
BASE = GRID[0] * GRID[1]
# fp32 port against the fp32 reference: the same equations in another order
# (fused QKV, RoPE on adjacent pairs against diffusers' repeated tables, the
# port's fp32 attention plain version in exp2 units); measured ~1e-6 relative
REL = 2e-5


def diffusers_state_dict(seed: int = 0, cfg: FluxConfig = CFG) -> dict:
    """Random weights in diffusers' FluxTransformer2DModel key space: every
    linear uniform in +-1/sqrt(fan_in), biases alike, RMSNorm gains around
    one, so that a gain or a half put in the wrong place shows."""
    g = torch.Generator().manual_seed(seed)
    d, hd, f = cfg.dim, cfg.head_dim, cfg.mlp_dim
    sd = {}

    def lin(name, d_in, d_out):
        bound = 1.0 / math.sqrt(d_in)
        sd[f"{name}.weight"] = (torch.rand(d_out, d_in, generator=g) * 2 - 1) * bound
        sd[f"{name}.bias"] = (torch.rand(d_out, generator=g) * 2 - 1) * bound

    def gain(name):
        sd[f"{name}.weight"] = 1.0 + 0.3 * torch.randn(hd, generator=g)

    lin("x_embedder", cfg.patch_dim, d)
    lin("context_embedder", cfg.txt_in_dim, d)
    for e, d_in in (("timestep_embedder", cfg.time_dim), ("guidance_embedder", cfg.time_dim),
                    ("text_embedder", cfg.pooled_dim)):
        lin(f"time_text_embed.{e}.linear_1", d_in, d)
        lin(f"time_text_embed.{e}.linear_2", d, d)
    for i in range(cfg.num_layers):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear", d, 6 * d)
        lin(f"{p}.norm1_context.linear", d, 6 * d)
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            lin(f"{p}.attn.{n}", d, d)
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            gain(f"{p}.attn.{n}")
        lin(f"{p}.attn.to_out.0", d, d)
        lin(f"{p}.attn.to_add_out", d, d)
        for ff in ("ff", "ff_context"):
            lin(f"{p}.{ff}.net.0.proj", d, f)
            lin(f"{p}.{ff}.net.2", f, d)
    for i in range(cfg.num_single_layers):
        p = f"single_transformer_blocks.{i}"
        lin(f"{p}.norm.linear", d, 3 * d)
        for n in ("to_q", "to_k", "to_v"):
            lin(f"{p}.attn.{n}", d, d)
        gain(f"{p}.attn.norm_q")
        gain(f"{p}.attn.norm_k")
        lin(f"{p}.proj_mlp", d, f)
        lin(f"{p}.proj_out", d + f, d)
    lin("norm_out.linear", d, 2 * d)
    lin("proj_out", d, cfg.patch_dim)
    return sd


@pytest.fixture(scope="module")
def sd():
    return diffusers_state_dict()


@pytest.fixture(scope="module")
def dit(sd):
    return C.flux_from_state_dict(sd, dtype=torch.float32, device="cpu")


def _inputs(batch: int = 1, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    return {"img": torch.randn(batch, 2 * BASE, CFG.patch_dim, generator=g),
            "txt": torch.randn(batch, S_T, CFG.txt_in_dim, generator=g),
            "t": torch.rand(batch, generator=g),
            "guidance": 1.0 + 3.0 * torch.rand(batch, generator=g),
            "pooled": torch.randn(batch, CFG.pooled_dim, generator=g)}


def _ref_ids():
    return (torch.zeros(S_T, 3),
            torch.cat([ref.image_ids(*GRID), ref.image_ids(*GRID, first=1)]))


def _ropes():
    return [torch.from_numpy(t) for t in flux_rope_tables([(1, *GRID), (1, *GRID)], S_T)]


def _rel(got, want):
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("batch,slim", [(1, 0), (1, BASE), (2, BASE)],
                         ids=["full", "slim", "batch2_slim"])
def test_dit_forward_matches_the_reference(sd, dit, batch, slim):
    """The whole DiT from diffusers' state dict against the reference's
    ``FluxTransformer2DModel.forward``; at batch 2 the rows differ, so a
    single-stream block's strided text / image views are read per row."""
    x = _inputs(batch)
    with torch.no_grad():
        got = dit(x["img"], x["txt"], x["t"], *_ropes(), slim_last=slim,
                  guidance=x["guidance"], pooled=x["pooled"])
    want = ref.transformer(sd, x["img"], x["txt"], x["t"], x["guidance"], x["pooled"],
                           *_ref_ids(), CFG.num_heads)
    assert got.shape == (batch, slim or 2 * BASE, CFG.patch_dim)
    assert _rel(got, want[:, :got.shape[1]]) < REL


def _block_inputs(seed: int = 2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(1, 2 * BASE, CFG.dim, generator=g),
            torch.randn(1, S_T, CFG.dim, generator=g), torch.randn(1, CFG.dim, generator=g))


def _ref_rope():
    return ref.pos_embed(torch.cat(_ref_ids()))


def test_double_block_matches_the_reference(sd, dit):
    """A double-stream block alone: ``DiTBlock`` with the tanh GELU against
    ``FluxTransformerBlock``."""
    image, text, temb = _block_inputs()
    with torch.no_grad():
        t_out, i_out = dit.blocks[1](image, text, torch.nn.functional.silu(temb), *_ropes(),
                                     None)
    t_want, i_want = ref.double_block(sd, "transformer_blocks.1", image, text, temb,
                                      *_ref_rope(), CFG.num_heads)
    assert _rel(t_out, t_want) < REL and _rel(i_out, i_want) < REL


def test_single_block_matches_the_reference(sd, dit):
    """A single-stream block alone against ``FluxSingleTransformerBlock``."""
    image, text, temb = _block_inputs()
    x = torch.cat([text, image], dim=1)
    with torch.no_grad():
        got = dit.single_blocks[0](x, S_T, torch.nn.functional.silu(temb), *_ropes())
    want = ref.single_block(sd, "single_transformer_blocks.0", x, temb, *_ref_rope(),
                            CFG.num_heads)
    assert got.shape == x.shape and _rel(got, want) < REL


@pytest.mark.parametrize("batch", [1, 2])
def test_slim_single_block_is_the_full_blocks_target_rows(dit, batch):
    """The slim last block queries and carries only the first ``slim_base``
    image rows: the same as the full block's rows there (the products over
    fewer rows may round apart at fp32's last bits)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(batch, S_T + 2 * BASE, CFG.dim, generator=g)
    temb_silu = torch.nn.functional.silu(torch.randn(batch, CFG.dim, generator=g))
    blk = dit.single_blocks[1]
    with torch.no_grad():
        full = blk(x, S_T, temb_silu, *_ropes())
        slim = blk(x, S_T, temb_silu, *_ropes(), slim_base=BASE)
    torch.testing.assert_close(slim, full[:, S_T:S_T + BASE], rtol=1e-5, atol=1e-5)


def test_schedule_matches_its_formula():
    """``flux_schedule`` against diffusers' (float32 sigmas shifted in
    float32; the port shifts in float64 and rounds once, so within 2 float32
    ulps), at 28 steps over 4,096 target tokens (mu 1.15) and at 2 over 16."""
    for steps, seq in ((28, 4096), (2, 16)):
        s = fm.flux_schedule(steps, seq)
        sigmas, timesteps = ref.schedule(steps, seq)
        np.testing.assert_allclose(s.sigmas, sigmas[:-1].numpy(), rtol=2.4e-7)
        np.testing.assert_allclose(s.sigmas_next, sigmas[1:].numpy(), rtol=2.4e-7)
        np.testing.assert_allclose(s.timesteps, timesteps.numpy(), rtol=2.4e-7)
        assert s.sigmas[0] == 1.0 and s.sigmas_next[-1] == 0.0
    mu = fm.calculate_shift(4096, 256, 4096, 0.5, 1.15)
    assert abs(mu - 1.15) < 1e-12


def test_rope_tables_are_fluxs_position_ids():
    """The port's tables against ``FluxPosEmbed`` of diffusers' ids (text 0,
    target (0, i, j), context (1, i, j)); the text rotation is the identity."""
    img_cos, img_sin, txt_cos, txt_sin = _ropes()
    cos, sin = _ref_rope()
    np.testing.assert_allclose(torch.cat([txt_cos, img_cos]), cos[:, 0::2], atol=1e-7)
    np.testing.assert_allclose(torch.cat([txt_sin, img_sin]), sin[:, 0::2], atol=1e-7)
    assert torch.all(txt_cos == 1) and torch.all(txt_sin == 0)


def test_kontext_denoise_matches_the_reference_loop(sd, dit):
    """Two steps of the Kontext edit through the pipeline's entry (noise
    [1, h, w, 16], the context's packed tokens, T5 rows, the pooled vector,
    guidance 2.5) against the reference loop on packed latents."""
    g = torch.Generator().manual_seed(4)
    h, w = 2 * GRID[0], 2 * GRID[1]
    noise = torch.randn(1, h, w, 16, generator=g)
    ctx = torch.randn(1, BASE, CFG.patch_dim, generator=g)
    t5 = torch.randn(1, S_T, CFG.txt_in_dim, generator=g)
    pooled = torch.randn(1, CFG.pooled_dim, generator=g)
    pipe = FluxKontextPipeline(dit, dtype=torch.float32, device="cpu")
    got = pipe(noise, t5, pooled, ctx, GRID, guidance=2.5, num_inference_steps=2)
    want = ref.kontext_denoise(sd, ref.pack(noise.permute(0, 3, 1, 2)), GRID, ctx, GRID, t5,
                               pooled, 2.5, 2, CFG.num_heads)
    assert pipe.timings["denoise"] > 0
    assert _rel(ref.pack(got.permute(0, 3, 1, 2)), want) < REL


def test_the_two_reference_copies_agree(sd, dit):
    """``pebench/reference/flux.py`` (the benchmark's copy: the port's key
    names, drawn per group, its own tables) against this suite's copy on
    the same weights, its embedding table kept in fp32 as diffusers keeps
    it (the benchmark rounds it through bf16, as the bf16 deployment does)."""
    from pebench.reference import flux as bench_ref

    params = {k: v for k, v in dit.state_dict().items()}

    def weights(group):
        return {k: v for k, v in params.items()
                if k == group or k.startswith(group + ".")}

    x = _inputs()
    cfg = {k: getattr(CFG, k) for k in ("num_layers", "num_single_layers", "num_heads",
                                        "head_dim", "time_dim")}
    tables = [torch.from_numpy(t) for t in bench_ref.tables([(1, *GRID), (1, *GRID)], S_T)]
    got = bench_ref.dit_forward(weights, cfg, x["img"], x["txt"], x["t"], x["guidance"],
                                x["pooled"], tables, BASE, table_dtype=torch.float32)
    want = ref.transformer(sd, x["img"], x["txt"], x["t"], x["guidance"], x["pooled"],
                           *_ref_ids(), CFG.num_heads)[:, :BASE]
    assert _rel(got, want) < REL
    s, s_next, ts = bench_ref.schedule(28, 4096)
    sigmas, timesteps = ref.schedule(28, 4096)
    np.testing.assert_allclose(s, sigmas[:-1].numpy(), rtol=2.4e-7)
    np.testing.assert_allclose(ts, timesteps.numpy(), rtol=2.4e-7)


def test_key_map_reads_diffusers_layout(sd, dit):
    """The key map covers every published key once; the QKV projections are
    fused in q, k, v order (the text stream's from ``add_*_proj``); the
    single blocks' ``proj_mlp`` / ``proj_out`` and ``norm_out``'s
    scale-then-shift halves are copied as they are; writing back gives the
    same state dict."""
    d = CFG.dim
    b0, s0 = dit.blocks[0].attn, dit.single_blocks[1]
    for i, n in enumerate(("to_q", "to_k", "to_v")):
        assert torch.equal(b0["img_qkv"].weight[i * d:(i + 1) * d],
                           sd[f"transformer_blocks.0.attn.{n}.weight"])
        assert torch.equal(s0.attn["qkv"].bias[i * d:(i + 1) * d],
                           sd[f"single_transformer_blocks.1.attn.{n}.bias"])
    for i, n in enumerate(("add_q_proj", "add_k_proj", "add_v_proj")):
        assert torch.equal(b0["txt_qkv"].weight[i * d:(i + 1) * d],
                           sd[f"transformer_blocks.0.attn.{n}.weight"])
    assert torch.equal(s0.proj_mlp.weight, sd["single_transformer_blocks.1.proj_mlp.weight"])
    assert torch.equal(s0.proj_out.weight, sd["single_transformer_blocks.1.proj_out.weight"])
    assert torch.equal(dit.norm_out["linear"].weight[:d], sd["norm_out.linear.weight"][:d])
    back = C.flux_to_state_dict(dit)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert C.flux_config_from_state_dict(sd) == CFG


def test_attn_clamp_reads_the_single_blocks_gains(sd):
    """K1's clamp rule reads every gain of both block kinds: gains of one
    leave it off; one single block's key gain of 8 turns it on."""
    dit = C.flux_from_state_dict(sd, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if ".norm_" in name:
                p.fill_(1.0)
    assert t_dit.attn_clamp_needed(dit) is False
    with torch.no_grad():
        dit.single_blocks[1].attn["norm_k"].scale.fill_(8.0)
    assert t_dit.attn_clamp_needed(dit) is True


@pytest.mark.parametrize("lane", [{"attn_bias_log2": torch.zeros(1)}, {"attn_impl": "dense"},
                                  {"txt_key_mask": torch.ones(1, S_T, dtype=torch.bool)}],
                         ids=["eligen", "dense", "key_mask"])
def test_forward_refuses_the_qwen_only_lanes(dit, lane):
    """``denoise`` hands every DiT the Qwen-Image lanes' inputs; the FLUX
    DiT refuses any it would otherwise drop."""
    x = _inputs()
    with torch.no_grad(), pytest.raises(ValueError, match="no key mask"):
        dit(x["img"], x["txt"], x["t"], *_ropes(), guidance=x["guidance"],
            pooled=x["pooled"], **lane)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


# name: batch, heads, text rows, image rows (two h x w images), slim_base
JOINT_CASES = {"cell_block": (1, 24, 512, (64, 64), 0),
               "cell_slim_block": (1, 24, 512, (64, 64), 4096),
               "batch2_strided": (2, 24, 40, (4, 8), 0),
               "batch2_strided_slim": (2, 6, 37, (4, 8), 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(JOINT_CASES))
def test_joint_qkv_mode_matches_its_plain_version_on_cuda(cuda, case):
    """The q / k kernel on a single-stream block's one QKV tensor (its text
    and image rows as the two streams' views, strided at batch 2, no copy):
    one launch with grad off; v bit for bit; q and k rows bit for bit but at
    most QK_ROWS_APART_MAX of them, each the eager row with its bf16 rsqrt
    one ulp away (``chip_smoke.head_rows_agreement``, the two-stream gates).
    With grad on no launch, and the plain version's bits and gradients."""
    from chip_smoke import head_rows_agreement

    b, n, s_t, (h, w), slim = JOINT_CASES[case]
    g = torch.Generator(cuda).manual_seed(11)
    qkv = (2.0 * torch.randn(b, s_t + 2 * h * w, 3 * n * 128, device=cuda,
                             generator=g)).bfloat16()
    gains = ((1.0 + 0.3 * torch.randn(128, device=cuda, generator=g)).bfloat16(),
             torch.full((128,), 4.0, device=cuda, dtype=torch.bfloat16))
    tables = [torch.from_numpy(t).to(cuda)
              for t in flux_rope_tables([(1, h, w), (1, h, w)], s_t)]
    before = tqk.LAUNCHES["qk_norm_rope"]
    with torch.no_grad():
        got = tqk.qk_norm_rope_joint(qkv, s_t, gains, *tables, 1e-6, slim)
    assert tqk.LAUNCHES["qk_norm_rope"] == before + 1
    args = (qkv[:, s_t:], qkv[:, :s_t], gains * 2, *tables)
    want = tqk.qk_norm_rope_reference(*args, 1e-6, slim)
    assert torch.equal(got[2], want[2])
    for which in (0, 1):
        agree = head_rows_agreement(got[which], want[which], args, which, slim)
        assert agree["rows_explained"], agree

    # with grad on: no launch, the plain version's bits and gradients
    mine, plain = ([t.detach().clone().requires_grad_() for t in (qkv, *gains)]
                   for _ in range(2))
    with torch.enable_grad():
        got = tqk.qk_norm_rope_joint(mine[0], s_t, mine[1:], *tables, 1e-6, slim)
        want = tqk.qk_norm_rope_reference(plain[0][:, s_t:], plain[0][:, :s_t],
                                          tuple(plain[1:]) * 2, *tables, 1e-6, slim)
        cot = [torch.randn(t.shape, device=cuda, generator=g).bfloat16() for t in want]
        grads = [torch.autograd.grad(out, leaves, cot) for out, leaves in ((got, mine),
                                                                            (want, plain))]
    assert tqk.LAUNCHES["qk_norm_rope"] == before + 1
    assert all(map(torch.equal, got, want)) and all(map(torch.equal, *grads))


@pytest.mark.cuda
def test_flux_dit_launches_the_kernel_once_a_block_on_cuda(cuda, sd):
    """A tiny bf16 FLUX DiT on the card launches the q / k kernel once a
    block, double and single (4), with grad off and never with grad on; the
    two forwards agree within bf16 rounding."""
    dit = C.flux_from_state_dict(sd, dtype=torch.bfloat16, device=cuda)
    x = {k: v.to(cuda).bfloat16() for k, v in _inputs(2).items()}
    ropes = [t.to(cuda) for t in _ropes()]

    def forward():
        return dit(x["img"], x["txt"], x["t"], *ropes, slim_last=BASE, guidance=x["guidance"],
                   pooled=x["pooled"], attn_clamp=t_dit.attn_clamp_needed(dit))

    tqk.reset_launch_counts()
    with torch.no_grad():
        fused = forward()
    assert tqk.LAUNCHES["qk_norm_rope"] == CFG.num_layers + CFG.num_single_layers
    with torch.enable_grad():
        eager = forward()
    assert tqk.LAUNCHES["qk_norm_rope"] == CFG.num_layers + CFG.num_single_layers
    assert fused.shape == (2, BASE, CFG.patch_dim) and _rel(fused.float(), eager.float()) < 1e-2

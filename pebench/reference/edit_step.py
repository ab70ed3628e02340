"""One denoise step of a PhysicEdit edit, worked out by the plain reference
from the state the program held before it, and compared with what the
program produced.

A step rewrites the 64 special-token rows with the dual adapter (from the
rows the previous step left), runs the DiT on both CFG rows (the positive
prompt first), combines them as ``v_neg + cfg * (v_pos - v_neg)`` and takes
the Euler step ``x + v * (sigma_next - sigma)``.  The configuration keeps
the latents and the DiT's output in bf16, and the combine and the step are
bf16 and fp32 arithmetic that admit one result, so the step is compared
exactly; the rewrite, the DiT's output on each row and the CFG-combined
velocity are compared by relative L2 against fp32.
"""

from __future__ import annotations

import torch

from pebench.reference import adapter as ref_adapter
from pebench.reference import dit as ref_dit
from pebench.reference.arith import Arith


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        return float("inf")
    den = want.norm().item()
    num = (got - want).norm().item()
    return num / den if den > 0 else num


def tokens_of(latents: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] latents -> [B, H/2 * W/2, 4C] tokens, feature c*4 + 2p + q."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def guided(out: torch.Tensor, cfg_scale: float) -> torch.Tensor:
    """The CFG-combined velocity in fp32 (positive row first)."""
    out = out.float()
    return out[1:2] + cfg_scale * (out[0:1] - out[1:2])


def euler(lat_tokens: torch.Tensor, out: torch.Tensor, cfg_scale: float, sigma: float,
          sigma_next: float) -> torch.Tensor:
    """The CFG combine in bf16 and the Euler step in fp32, back to bf16.
    lat_tokens [1, base, 64] bf16; out [2, base, 64] bf16 (positive first)."""
    v_pos, v_neg = out[0:1], out[1:2]
    v = v_neg + cfg_scale * (v_pos - v_neg)
    s = torch.tensor(sigma, dtype=torch.float32, device=out.device)
    sn = torch.tensor(sigma_next, dtype=torch.float32, device=out.device)
    return (lat_tokens.float() + v.float() * (sn - s)).to(lat_tokens.dtype)


@torch.no_grad()
def reference_step(dit_weights, adapter_weights, cfg: dict, rows_pre, special_idx, txt_mask,
                   img_tokens, timestep: float, t_range: tuple, ropes, base: int,
                   arith: Arith):
    """(rows, dit_out): the rewritten rows [B, S_t, D] and the DiT's output
    [B, base, 64], fp32, from the state before the step.  img_tokens [B,
    S_i, 64] as the step received them."""
    rows = ref_adapter.rewrite(adapter_weights, rows_pre, special_idx, timestep, t_range, arith)
    t_bf16 = torch.full((rows.shape[0],), timestep, dtype=torch.float32,
                        device=rows.device).div(1000.0).to(torch.bfloat16)
    out = ref_dit.dit_forward(dit_weights, cfg, img_tokens, rows, t_bf16, ropes, txt_mask,
                              base, arith)
    return rows, out


def compare_step(prog: dict, ref_rows, ref_out, special_idx, cfg_scale: float, sigma: float,
                 sigma_next: float) -> dict:
    """The compared numbers of one step.  prog: ``rows`` (the rows the
    program's DiT received), ``out`` (its output), ``lat`` and ``lat_next``
    (the base latent tokens before and after the step)."""
    b = torch.arange(ref_rows.shape[0], device=ref_rows.device)[:, None]
    base = ref_out.shape[1]
    out = prog["out"]
    rows_rel = rel_l2(prog["rows"][b, special_idx], ref_rows[b, special_idx])
    dit_rel = rel_l2(out[:, :base], ref_out)
    cfg_rel = (rel_l2(guided(out[:, :base], cfg_scale), guided(ref_out, cfg_scale))
               if out.shape[0] == 2 else float("inf"))
    if out.shape[0] != 2 or out.shape[1] < base:
        mismatch = prog["lat_next"].numel()
    else:
        want = euler(prog["lat"], out[:, :base], cfg_scale, sigma, sigma_next)
        got = prog["lat_next"]
        mismatch = (int((got != want).sum().item()) if got.shape == want.shape
                    else got.numel())
    return {"rows_rel": rows_rel, "dit_rel": dit_rel, "cfg_rel": cfg_rel,
            "step_mismatch": mismatch}

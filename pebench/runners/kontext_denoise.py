"""The general runner of Kontext traffic: whole FLUX.1 Kontext edit
denoises, back to back, through ``FluxKontextPipeline._run_denoise``.

A traffic file of this kind gives the output size, the context image's
size, the steps, the distilled guidance and the T5 rows' length.  Set-up
builds the configuration's FLUX DiT on the card with weights drawn from the
seed (``pebench/weights.py``), makes the edit's noise, the context image's
packed latents, the T5 rows and the pooled CLIP vector from the seed (at the
encoders' output widths: the encoders and the VAE are not in the program),
and runs one short denoise at the same shapes.  The window runs whole edits
until the next would not end inside it; the first always runs.

The check compares two steps of the window's first edit with the plain
reference (``pebench/reference/flux.py``): step 0, from the inputs set-up
made, and a step drawn from the seed, from the latents the program held
before it; the reference takes the context image, the T5 rows, the pooled
vector and the guidance from the runner's own inputs.  ``dit_rel`` is the
rel-L2 of the DiT's output over the target's rows against fp32,
``step_mismatch`` the elements of the next latents off the fp32 Euler step
of the program's own output.

``FAULTS`` holds the fault this kind of traffic adds to ``pebench/faults.py``'s
(registered there on import, so ``control.py --fault context_dropped`` plants
it): ``context_dropped``, in which every DiT call sees the target's tokens
alone, the context image's rows gone from the sequence.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pebench import faults as F
from pebench import weights as W
from pebench.reference import flux as ref_flux
from pebench.reference.arith import Arith
from pebench.reference.edit_step import rel_l2
from pebench.runners import edit_denoise


def context_dropped():
    from physicedit_torch.models.flux import FluxDiT

    orig = FluxDiT.forward

    def forward(self, img, txt, t, img_cos, img_sin, *args, slim_last=0, **kwargs):
        n = slim_last or img.shape[1]
        return orig(self, img[:, :n], txt, t, img_cos[:n], img_sin[:n], *args,
                    slim_last=slim_last, **kwargs)

    return F._patched(FluxDiT, "forward", forward)


FAULTS = {"context_dropped": context_dropped}
for _name, _fault in FAULTS.items():
    F.FAULTS.setdefault(_name, _fault)


class Runner(edit_denoise.Runner):
    """The edit runner's window (whole edits, the traced steps, the hooks
    that keep the checked steps' state), end-to-end metric, release and
    check, over the Kontext pipeline and the FLUX reference."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        t = traffic
        self.height, self.width = t["height"], t["width"]
        self.lat_h, self.lat_w = self.height // 8, self.width // 8
        self.base = (self.lat_h // 2) * (self.lat_w // 2)
        self.ctx_hw = (t["context_image"]["height"] // 16, t["context_image"]["width"] // 16)
        self.img_shapes = [(1, self.lat_h // 2, self.lat_w // 2), (1, *self.ctx_hw)]
        self.extra = self.ctx_hw[0] * self.ctx_hw[1]
        self.steps, self.guidance, self.s_t = t["steps"], float(t["guidance"]), t["txt_len"]
        self.dit_cfg = dict(config["dit"])
        self.pipe = None
        self.capture = None

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------

    def _inputs(self) -> dict:
        """The edit's noise, context latents, T5 rows and pooled vector, made
        on the card, N(0, 1) in the configuration's dtype."""
        gen = torch.Generator(self.device).manual_seed(W.mix(self.seed, "edit", 0))
        dtype = getattr(torch, self.config["dtype"])
        c = self.dit_cfg

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=self.device).to(dtype)

        return {"noise": randn(1, self.lat_h, self.lat_w, 16),
                "context": randn(1, self.extra, c["patch_dim"]),
                "t5": randn(1, self.s_t, c["txt_in_dim"]),
                "pooled": randn(1, c["pooled_dim"])}

    def setup(self) -> None:
        from physicedit_torch.kernels import _build
        from physicedit_torch.models.flux import FluxConfig, FluxDiT
        from physicedit_torch.pipeline.kontext_pipeline import FluxKontextPipeline

        marks = [time.perf_counter()]
        if self.device.type == "cuda":
            _build.build_all(["fixedmax_attention", "qk_norm_rope"])
        marks.append(time.perf_counter())
        c = self.config
        dtype = getattr(torch, c["dtype"])
        dit = FluxDiT(FluxConfig(**c["dit"]), dtype)
        self.weights = W.ModelWeights("dit", dit, self.seed, self.device, dtype,
                                      c.get("gains", {}).get("dit"))
        self.weights.load_into(dit)
        self.pipe = FluxKontextPipeline(dit, dtype, self.device)
        del dit
        self.inputs = self._inputs()
        self._sync()
        marks.append(time.perf_counter())
        # one short denoise at the window's shapes: builds and loads every
        # kernel, and sizes the allocator's pools
        self._edit(self.inputs, steps=2)
        self._sync()
        marks.append(time.perf_counter())
        self.setup_phases = dict(zip(("build_s", "weights_inputs_s", "warmup_s"),
                                     np.diff(marks).tolist()))

    # ------------------------------------------------------------------
    # the timed path
    # ------------------------------------------------------------------

    def _edit(self, inp: dict, steps: int | None = None):
        from physicedit_torch.ops import rope as m_rope
        from physicedit_torch.sampling import flow_match as fm

        steps = self.steps if steps is None else steps
        sched = fm.flux_schedule(steps, self.base)
        ropes = m_rope.flux_rope_tables(self.img_shapes, self.s_t,
                                        tuple(self.config["rope_axes"]))
        return self.pipe._run_denoise(inp["noise"], inp["context"], inp["t5"], inp["pooled"],
                                      self.guidance, ropes, sched, (self.lat_h, self.lat_w))

    def shapes(self) -> dict:
        """The shapes of one step (one DiT row), for the roofline and FLOP
        counts."""
        d = self.dit_cfg
        return {"rows": 1, "img_tokens": self.base + self.extra, "base": self.base,
                "txt": self.s_t, "heads": d["num_heads"], "head_dim": d["head_dim"],
                "dim": d["dim"], "mlp_dim": 4 * d["dim"], "layers": d["num_layers"],
                "single_layers": d["num_single_layers"], "txt_in_dim": d["txt_in_dim"],
                "pooled_dim": d["pooled_dim"], "patch_dim": d["patch_dim"],
                "time_dim": d["time_dim"]}

    # ------------------------------------------------------------------
    # the check
    # ------------------------------------------------------------------

    def rows_apart(self):
        """No CFG rows: the guidance is distilled into the DiT."""
        return None

    def _checked_steps(self, ariths: list):
        """For each checked step: the program's state and the reference's
        output in each of ``ariths`` from the state before the step:
        ``(j, prog, [out, ...])``, or ``(j, None, [])`` when the window
        missed a call of that step."""
        sig, sig_next, ts = ref_flux.schedule(self.steps, self.base)
        self.sigmas = (sig, sig_next)
        ropes = tuple(torch.from_numpy(r).to(self.device) for r in ref_flux.tables(
            self.img_shapes, self.s_t, tuple(self.config["rope_axes"])))
        inp = self.inputs
        g = torch.full((1,), self.guidance, dtype=torch.bfloat16, device=self.device)
        for j in self.check_steps:
            prog = self.capture.step(j, self.outputs[0], inp["t5"], self.base)
            if prog is None:
                yield j, None, []
                continue
            img = torch.cat([prog["lat"], inp["context"]], dim=1)
            t_bf16 = torch.full((1,), float(ts[j]), dtype=torch.float32,
                                device=self.device).div(1000.0).to(torch.bfloat16)
            refs = [ref_flux.dit_forward(self.weights.group, self.dit_cfg, img, inp["t5"], t_bf16,
                                         g, inp["pooled"], ropes, self.base, a) for a in ariths]
            yield j, prog, refs

    def _compare(self, j: int, prog: dict, out) -> dict:
        got = prog["out"]
        want = ref_flux.euler(prog["lat"], got[:, :self.base], float(self.sigmas[0][j]),
                              float(self.sigmas[1][j]))
        lat_next = prog["lat_next"]
        mismatch = (int((lat_next != want).sum().item()) if lat_next.shape == want.shape
                    else lat_next.numel())
        return {"dit_rel": rel_l2(got[:, :self.base], out), "step_mismatch": mismatch}

    def readings(self, arith: Arith) -> dict:
        """The compared numbers of the checked steps, the largest over them:
        the program against the reference computed in ``arith``."""
        worst: dict = {}
        for j, prog, refs in self._checked_steps([arith]):
            if prog is None:
                return {"dit_rel": float("inf"), "step_mismatch": float("inf")}
            for k, v in self._compare(j, prog, refs[0]).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def control_readings(self, arith: Arith, control: Arith) -> tuple:
        """(program, control): the same numbers for the program and for the
        reference computed in ``control`` put in its place, both against the
        reference in ``arith``, from the program's states."""
        prog_w, ctrl_w = {}, {}
        for j, prog, refs in self._checked_steps([arith, control]):
            if prog is None:
                raise RuntimeError(f"the window missed a DiT call of step {j}")
            out, c_out = refs
            for w, g in ((prog_w, self._compare(j, prog, out)),
                         (ctrl_w, {"dit_rel": rel_l2(c_out, out)})):
                for k, v in g.items():
                    w[k] = max(w.get(k, 0.0), v)
        return prog_w, ctrl_w

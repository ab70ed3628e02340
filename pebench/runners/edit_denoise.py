"""The general runner of edit traffic: whole CFG denoises of PhysicEdit
edits, back to back, through ``PhysicEditPipeline._run_denoise``.

A traffic file of this kind gives the output size, the steps, the CFG
scale, the text rows of each CFG row (tokens before and after the 64
special tokens, and the bucket they are padded to) and the kind of edit
image.  Set-up builds the configuration's models on the card with weights
drawn from the seed (``pebench/weights.py``), quantizes them when the
configuration says so, makes the edit's noise, edit-image tokens and
prompt rows from the seed, and runs one short denoise at the same shapes.
The window runs the edit until the next would not fit; the first always
runs.  (One edit fills a window of either lane, so a single set of inputs
serves; a cell whose window holds several edits would want one set each.)

The check compares two steps of the window's first edit with the plain
reference (``pebench/reference/``): step 0, from the inputs set-up made,
and a step drawn from the seed, from the state the program held before it
(the latents and the special-token rows the previous step left).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from pebench import weights as W
from pebench.reference import edit_step as ref_step
from pebench.reference import rope as ref_rope
from pebench.reference import schedule as ref_schedule
from pebench.reference.arith import Arith


def _dataclass(cls, fields: dict):
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        t = traffic
        self.height, self.width = t["height"], t["width"]
        self.lat_h, self.lat_w = self.height // 8, self.width // 8
        self.base = (self.lat_h // 2) * (self.lat_w // 2)
        eh, ew = t["edit_image"]["height"] // 16, t["edit_image"]["width"] // 16
        self.img_shapes = [(1, self.lat_h // 2, self.lat_w // 2), (1, eh, ew)]
        self.extra = eh * ew
        self.steps, self.cfg_scale = t["steps"], float(t["cfg_scale"])
        rows = t["text_rows"]
        self.specials = [r["before_special"] for r in rows]
        self.valid = [r["before_special"] + 64 + r["after_special"] for r in rows]
        bucket = t["txt_len_bucket"]
        self.s_t = -(-max(self.valid) // bucket) * bucket
        self.pipe = None
        self.capture = None

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------

    def _models(self):
        from physicedit_torch.models.adapters import DualAdapter
        from physicedit_torch.models.dit import DiT, DiTConfig
        from physicedit_torch.models.qwen_vl import QwenVLText, QwenVLTextConfig
        from physicedit_torch.models.qwen_vl_vision import QwenVLVision, QwenVLVisionConfig
        from physicedit_torch.models.vae import VAE, VAEConfig

        c = self.config
        dtype = getattr(torch, c["dtype"])
        self.dit_cfg = dict(c["dit"])
        return {
            "dit": DiT(_dataclass(DiTConfig, c["dit"]), dtype),
            "text": QwenVLText(_dataclass(QwenVLTextConfig, c["text"]), dtype),
            "vision": QwenVLVision(_dataclass(QwenVLVisionConfig, c["vision"]), dtype),
            "vae": VAE(_dataclass(VAEConfig, c["vae"]), dtype),
            "adapter": DualAdapter(c["adapter_dim"], c["adapter_dim"], dtype),
        }

    def _inputs(self) -> dict:
        """The edit's noise, edit-image tokens and prompt rows, made on the card."""
        gen = torch.Generator(self.device).manual_seed(W.mix(self.seed, "edit", 0))
        dtype = getattr(torch, self.config["dtype"])
        d = self.config["text"]["hidden_size"]
        noise = torch.randn((1, self.lat_h, self.lat_w, 16), generator=gen,
                            device=self.device).to(dtype)
        extra = torch.randn((1, self.extra, self.config["dit"]["patch_dim"]), generator=gen,
                            device=self.device).to(dtype)
        rows = torch.randn((2, self.s_t, d), generator=gen, device=self.device).to(dtype)
        mask = torch.zeros((2, self.s_t), dtype=torch.bool)
        for r, n in enumerate(self.valid):
            rows[r, n:] = 0
            mask[r, :n] = True
        specials = [np.arange(s, s + 64) for s in self.specials]
        return {"noise": noise, "extra": extra, "rows": rows,
                "rows_host": rows.float().cpu().numpy(), "mask": mask.numpy(),
                "specials": specials}

    def setup(self) -> None:
        from physicedit_torch.kernels import _build
        from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

        marks = [time.perf_counter()]
        if self.device.type == "cuda":
            names = ["fixedmax_attention"]
            if self.config.get("quantize") == "int4":
                names += ["w4a8_matmul", "fused_quant"]
            _build.build_all(names)
        marks.append(time.perf_counter())
        c = self.config
        mods = self._models()
        self.weights = {name: W.ModelWeights(name, m, self.seed, self.device,
                                             getattr(torch, c["dtype"]),
                                             c.get("gains", {}).get(name))
                        for name, m in mods.items()}
        for name, m in mods.items():
            self.weights[name].load_into(m)
        self.pipe = PhysicEditPipeline(
            dit=mods["dit"], vae=mods["vae"], text=mods["text"], vision=mods["vision"],
            adapter=mods["adapter"], dtype=getattr(torch, c["dtype"]), device=self.device,
            rope_axes=tuple(c["rope_axes"]), txt_len_bucket=self.traffic["txt_len_bucket"])
        del mods
        self._sync()
        marks.append(time.perf_counter())
        if c.get("quantize"):
            self.pipe.quantize_(c["quantize"])
        self.inputs = self._inputs()
        self._sync()
        marks.append(time.perf_counter())
        # one short denoise at the window's shapes: builds and loads every
        # kernel, and sizes the allocator's pools
        self._edit(self.inputs, steps=2)
        self._sync()
        marks.append(time.perf_counter())
        self.setup_phases = dict(zip(("build_s", "weights_s", "quantize_inputs_s", "warmup_s"),
                                     np.diff(marks).tolist()))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------------
    # the timed path
    # ------------------------------------------------------------------

    def _edit(self, inp: dict, steps: int | None = None):
        from physicedit_torch.ops import rope as m_rope
        from physicedit_torch.sampling import flow_match as fm

        pipe = self.pipe
        steps = self.steps if steps is None else steps
        sched = fm.build_schedule(steps, fm.QWEN_IMAGE_CONFIG,
                                  dynamic_shift_len=(self.height // 16) * (self.width // 16))
        ropes = m_rope.build_rope_tables(self.img_shapes, self.s_t, axes_dim=pipe.rope_axes)
        return pipe._run_denoise(inp["noise"], inp["extra"], inp["rows_host"], inp["mask"],
                                 inp["specials"], ropes, sched, self.cfg_scale,
                                 (self.lat_h, self.lat_w), None)

    def window(self, seconds: float, tracer=None) -> dict:
        """Whole edits until the next would not end inside ``seconds``; with
        a ``tracing.Tracer``, the first edit's ``traced_steps`` are traced."""
        rng = np.random.default_rng(W.mix(self.seed, "check"))
        self.check_steps = [0, int(rng.integers(1, self.steps))]
        traced = None
        if tracer is not None:
            first = min(self.traffic["traced_steps"]["first"], self.steps - 1)
            traced = (tracer, first, min(self.steps, first + self.traffic["traced_steps"]["count"]))
        self.capture = _Capture(self.check_steps, self.steps, traced)
        span = tracer.span if tracer is not None else None
        hooks = self.capture.attach(self.pipe.dit)
        outs = []
        self._sync()
        t0 = time.perf_counter()
        try:
            while True:
                n = len(outs)
                with span(f"pebench.edit.{n}") if span else contextlib.nullcontext():
                    outs.append(self._edit(self.inputs))
                self.capture.active = False
                self._sync()
                elapsed = time.perf_counter() - t0
                if elapsed + elapsed / len(outs) > seconds:
                    break
        finally:
            for h in hooks:
                h.remove()
            if tracer is not None and tracer.open:
                tracer.end(0)
        self.outputs = outs
        return {"seconds": elapsed, "attempted": len(outs), "steps": len(outs) * self.steps}

    def end_to_end(self, win: dict) -> dict:
        """The window's wall time over the CFG steps its edits ran."""
        return {"edit_step_ms": 1e3 * win["seconds"] / win["steps"]}

    def shapes(self) -> dict:
        """The shapes of one CFG step, for the roofline and FLOP counts."""
        d = self.config["dit"]
        return {"rows": 2, "img_tokens": self.base + self.extra, "base": self.base,
                "txt_valid": list(self.valid), "txt_padded": self.s_t,
                "heads": d["num_heads"], "head_dim": d["head_dim"], "dim": d["dim"],
                "mlp_dim": 4 * d["dim"], "layers": d["num_layers"],
                "txt_in_dim": d["txt_in_dim"], "patch_dim": d["patch_dim"],
                "time_dim": d["time_dim"], "adapter_dim": self.config["adapter_dim"],
                "specials": 64, "quantize": self.config.get("quantize")}

    # ------------------------------------------------------------------
    # the check
    # ------------------------------------------------------------------

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def failed(self) -> int:
        """Window edits whose output is not finite."""
        return sum(int(not torch.isfinite(o.float()).all()) for o in self.outputs)

    def rows_apart(self) -> float:
        """How far the text moves the velocity: the largest over the checked
        steps of ``|out_pos - out_neg| / |out_pos|``, the program's output."""
        return max(((o[0] - o[1]).float().norm() / o[0].float().norm()).item()
                   for o in self.capture.outputs.values())

    def _checked_steps(self, ariths: list):
        """For each checked step: the program's state and what the
        reference computes from its state before the step, in each of
        ``ariths``: ``(j, prog, [(rows, out), ...])``, or ``(j, None, [])``
        when the window missed a call of that step."""
        ref = self.config["reference"]
        sig, sig_next, ts = ref_schedule.schedule(
            self.steps, (self.height // 16) * (self.width // 16))
        self.sigmas = (sig, sig_next)
        t_range = ref_schedule.adapter_t_range()
        ropes = tuple(torch.from_numpy(r).to(self.device) for r in ref_rope.tables(
            self.img_shapes, self.s_t, tuple(self.config["rope_axes"])))
        inp = self.inputs
        self.special_idx = torch.as_tensor(np.stack(inp["specials"]), device=self.device)
        mask = torch.as_tensor(inp["mask"], device=self.device)
        for j in self.check_steps:
            prog = self.capture.step(j, self.outputs[0], inp["rows"], self.base)
            if prog is None:
                yield j, None, []
                continue
            img = torch.cat([prog["lat"].expand(2, -1, -1),
                             inp["extra"].expand(2, -1, -1)], dim=1)
            refs = [ref_step.reference_step(
                self.weights["dit"].group, self.weights["adapter"].group, self.dit_cfg,
                prog["rows_pre"], self.special_idx, mask, img, float(ts[j]), t_range, ropes,
                self.base, a) for a in ariths]
            yield j, prog, refs

    def readings(self, arith: Arith) -> dict:
        """The compared numbers of the checked steps, the largest over them:
        the program against the reference computed in ``arith``."""
        worst: dict = {}
        for j, prog, refs in self._checked_steps([arith]):
            if prog is None:
                return {"rows_rel": float("inf"), "dit_rel": float("inf"),
                        "cfg_rel": float("inf"), "step_mismatch": float("inf")}
            (rows, out), = refs
            got = ref_step.compare_step(prog, rows, out, self.special_idx, self.cfg_scale,
                                        float(self.sigmas[0][j]), float(self.sigmas[1][j]))
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def control_readings(self, arith: Arith, control: Arith) -> tuple:
        """(program, control): the same numbers for the program and for the
        reference computed in ``control`` put in its place, both against the
        reference in ``arith``, from the program's states."""
        prog_w, ctrl_w = {}, {}
        b = torch.arange(2, device=self.device)[:, None]
        for j, prog, refs in self._checked_steps([arith, control]):
            if prog is None:
                raise RuntimeError(f"the window missed a DiT call of step {j}")
            (rows, out), (c_rows, c_out) = refs
            got = ref_step.compare_step(prog, rows, out, self.special_idx, self.cfg_scale,
                                        float(self.sigmas[0][j]), float(self.sigmas[1][j]))
            idx = self.special_idx
            ctrl = {"rows_rel": ref_step.rel_l2(c_rows[b, idx], rows[b, idx]),
                    "dit_rel": ref_step.rel_l2(c_out, out),
                    "cfg_rel": ref_step.rel_l2(ref_step.guided(c_out, self.cfg_scale),
                                               ref_step.guided(out, self.cfg_scale))}
            for w, g in ((prog_w, got), (ctrl_w, ctrl)):
                for k, v in g.items():
                    w[k] = max(w.get(k, 0.0), v)
        return prog_w, ctrl_w

    def check(self) -> dict:
        """``{name: (value, limit)}``: the reference in the configuration's
        arithmetic against the program, and the outputs' finiteness."""
        limits = self.config["limits"]
        got = self.readings(Arith(self.config["reference"]["arith"]))
        got["nonfinite_edits"] = self.failed()
        return {k: (got[k], lim) for k, lim in limits.items()}


class _Capture:
    """Forward hooks on the DiT that keep, during the window's first edit,
    what the checked steps need: the inputs of the DiT calls around each
    checked step and the outputs of the checked calls (small clones)."""

    def __init__(self, steps: list, total: int, traced=None):
        self.traced = traced
        self.want_in = set()
        for j in steps:
            self.want_in.update({j - 1, j, j + 1})
        self.want_out = set(steps)
        self.total = total
        self.call = 0
        self.active = True
        self.inputs: dict = {}
        self.outputs: dict = {}

    def attach(self, dit) -> list:
        def pre(module, args, kwargs):
            if self.active and self.traced and self.call == self.traced[1]:
                self.traced[0].begin()
            if self.active and self.call in self.want_in:
                self.inputs[self.call] = (args[0].detach().clone(), args[1].detach().clone())

        def post(module, args, kwargs, out):
            if self.active:
                if self.call in self.want_out:
                    self.outputs[self.call] = out.detach().clone()
                self.call += 1
                if self.traced and self.call == self.traced[2]:
                    self.traced[0].end(self.traced[2] - self.traced[1])

        return [dit.register_forward_pre_hook(pre, with_kwargs=True),
                dit.register_forward_hook(post, with_kwargs=True)]

    def step(self, j: int, final_latents, rows0, base: int):
        """The program's state around step j (its base latent tokens before
        and after), or None when a call is missing."""
        try:
            img_j, rows_j = self.inputs[j]
            out = self.outputs[j]
            rows_pre = rows0 if j == 0 else self.inputs[j - 1][1]
            lat_next = (self.inputs[j + 1][0][:1] if j + 1 < self.total
                        else ref_step.tokens_of(final_latents))
        except KeyError:
            return None
        return {"rows_pre": rows_pre, "rows": rows_j, "out": out,
                "lat": img_j[:1, :base], "lat_next": lat_next[:, :base]}

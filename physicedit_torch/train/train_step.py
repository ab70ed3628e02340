"""The optimizers and the training step (``physicedit_tpu/train/train_step.py``).

:func:`make_optimizer` gives the JAX package's optimizers, written by hand
(there is no optax here), each with a constant learning rate:

- ``name="adamw"``, ``state_dtype=None``: ``optax.adamw`` (fp32 moments; the
  decoupled decay is added to the Adam update, eps outside the
  bias-corrected square root);
- ``name="adamw"``, ``state_dtype=torch.bfloat16``:
  ``scale_by_adam_low_memory`` + ``add_decayed_weights`` + ``scale(-lr)``:
  the same fp32 arithmetic every step, the moments rounded to bf16 after
  each update (half the state);
- ``name="adafactor"``: ``optax.adafactor`` as the JAX package configures it
  (no parameter scale, block-RMS clipping at 1.0, decay ``weight_decay *
  lr``; optax's defaults otherwise: decay rate 0.8, eps 1e-30, a leaf
  factored when its second-largest dim is at least 128, no momentum), in
  optax's chain order: factored RMS scaling, block-RMS clip, lr, decayed
  weights, negation.  Its state is a row and a column vector per factored
  leaf (in the parameter's dtype, as optax keeps it).  The arithmetic runs
  in fp32; optax runs it in the parameter's dtype, so a bf16 leaf rounds
  at other points;
- ``gradient_accumulation_steps = k > 1`` wraps either in
  ``optax.MultiSteps``: every call folds the gradients into a running mean
  (Welford's form, as optax), and only every k-th call steps the inner
  optimizer on that mean and clears it; in between the parameters and the
  inner state hold still.

Each parameter is updated in place, in chunks of at most ``CHUNK``
elements, so the fp32 temporaries stay small (the largest LoRA factor at
rank 128 is 141 M elements): AdamW's and the accumulation's arithmetic is
elementwise; Adafactor's factored leaves split along a dimension that is
not factored (its row and column means do not cross it), and its clip
reads the whole leaf's RMS in a first pass before a second applies the
update.  The expressions keep optax's order of operations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from physicedit_torch.train.loss import physic_training_loss

CHUNK = 1 << 24


@dataclasses.dataclass
class AdamState:
    count: int
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-5
    weight_decay: float = 1e-2
    state_dtype: torch.dtype | None = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, module: torch.nn.Module) -> AdamState:
        def zeros(p):
            return torch.zeros_like(p, dtype=self.state_dtype or p.dtype)

        params = dict(module.named_parameters())
        return AdamState(0, {n: zeros(p) for n, p in params.items()},
                         {n: zeros(p) for n, p in params.items()})

    @torch.no_grad()
    def step(self, module: torch.nn.Module, state: AdamState,
             grads: dict | None = None) -> AdamState:
        """Apply one update from each parameter's ``.grad`` (or ``grads``)."""
        state.count += 1
        b1, b2, eps = self.b1, self.b2, self.eps
        params = dict(module.named_parameters())
        dev = next(iter(params.values())).device
        c = torch.tensor(float(state.count), dtype=torch.float32, device=dev)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=dev) ** c   # fp32, as optax
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=dev) ** c
        for name, param in params.items():
            grad = _grad(param, grads, name)
            chunks = zip(param.view(-1).split(CHUNK), grad.reshape(-1).split(CHUNK),
                         state.mu[name].view(-1).split(CHUNK),
                         state.nu[name].view(-1).split(CHUNK))
            for p, g, m, v in chunks:
                if self.state_dtype is None:       # optax.scale_by_adam
                    g = g.to(m.dtype)
                    m_new = (1 - b1) * g + b1 * m
                    v_new = (1 - b2) * (g * g) + b2 * v
                else:                              # scale_by_adam_low_memory
                    g = g.float()
                    m_new = b1 * m.float() + (1 - b1) * g
                    v_new = b2 * v.float() + (1 - b2) * g * g
                u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                m.copy_(m_new)
                v.copy_(v_new)
                p.copy_(p + (-self.lr) * (u + self.weight_decay * p))
        return state


def _grad(param, grads, name):
    """``grads[name]``, else ``param.grad``; a parameter without one counts
    as a zero gradient, as in JAX."""
    g = grads[name] if grads is not None else param.grad
    return torch.zeros_like(param) if g is None else g


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's rule: (second-largest, largest) dim of a leaf whose
    second-largest dim is at least ``min_dim_size_to_factor``, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(tuple(shape))
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


@dataclasses.dataclass
class AdafactorState:
    count: int
    v_row: dict     # factored leaves: the mean over the largest dim
    v_col: dict     # and over the second-largest
    v: dict         # the other leaves: the full second moment


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-5
    weight_decay_rate: float = 1e-7     # the JAX package's weight_decay * lr
    decay_rate: float = 0.8
    eps: float = 1e-30
    clipping_threshold: float = 1.0
    min_dim_size_to_factor: int = 128

    def init(self, module: torch.nn.Module) -> AdafactorState:
        state = AdafactorState(0, {}, {}, {})
        for name, p in module.named_parameters():
            dims = factored_dims(p.shape, self.min_dim_size_to_factor)
            if dims is None:
                state.v[name] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state.v_row[name] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d0])
                state.v_col[name] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d1])
        return state

    def _chunks(self, name, param, grad, state):
        """(p, g, v_row, v_col) or (p, g, v) views of at most about CHUNK
        elements that the leaf's update treats independently."""
        if name in state.v:
            return list(zip(param.view(-1).split(CHUNK), grad.reshape(-1).split(CHUNK),
                            state.v[name].view(-1).split(CHUNK)))
        d1, d0 = factored_dims(param.shape, self.min_dim_size_to_factor)
        vr, vc = state.v_row[name], state.v_col[name]
        free = [i for i in range(param.dim()) if i not in (d0, d1)]
        if not free:
            return [(param, grad, vr, vc)]
        b = free[0]
        size = max(1, CHUNK // (param.numel() // param.shape[b]))
        return list(zip(param.split(size, b), grad.split(size, b),
                        vr.split(size, b - (b > d0)), vc.split(size, b - (b > d1))))

    @staticmethod
    def _scaled(g, stats, dims):
        """The factored-RMS update of a chunk from its new statistics: ``(v,)``,
        or ``(v_row, v_col)`` for a factored leaf."""
        g = g.float()
        if dims is None:
            return g * stats[0].float() ** -0.5
        d1, d0 = dims
        vr, vc = stats[0].float(), stats[1].float()
        row_col_mean = vr.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
        row_factor = (vr / row_col_mean) ** -0.5
        col_factor = vc ** -0.5
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)

    @torch.no_grad()
    def step(self, module: torch.nn.Module, state: AdafactorState,
             grads: dict | None = None) -> AdafactorState:
        """Apply one update from each parameter's ``.grad`` (or ``grads``)."""
        # optax's decay schedule, in fp32: 1 - (count + 1)^-0.8
        decay = np.float32(1.0) - np.float32(state.count + 1) ** np.float32(-self.decay_rate)
        keep, new = float(decay), float(np.float32(1.0) - decay)
        state.count += 1
        for name, param in module.named_parameters():
            grad = _grad(param, grads, name)
            dims = factored_dims(param.shape, self.min_dim_size_to_factor)
            chunks = self._chunks(name, param, grad, state)
            sumsq = torch.zeros((), dtype=torch.float32, device=param.device)
            for c in chunks:        # the new statistics, and the update's square sum
                g = c[1].float()
                g2 = g * g + self.eps
                if dims is None:
                    c[2].copy_(keep * c[2].float() + new * g2)
                else:
                    d1, d0 = dims
                    c[2].copy_(keep * c[2].float() + new * g2.mean(dim=d0))
                    c[3].copy_(keep * c[3].float() + new * g2.mean(dim=d1))
                sumsq += self._scaled(g, c[2:], dims).square().sum()
            # clip_by_block_rms: the whole leaf's RMS against the threshold
            denom = torch.clamp(torch.sqrt(sumsq / param.numel()) / self.clipping_threshold,
                                min=1.0)
            for c in chunks:
                u = (self._scaled(c[1], c[2:], dims) / denom) * self.lr
                p = c[0]
                p.copy_(p + -(u + self.weight_decay_rate * p))
        return state


@dataclasses.dataclass
class MultiStepsState:
    mini_step: int
    gradient_step: int
    inner: object       # the inner optimizer's state
    acc: dict           # the running mean of the gradients, per parameter


@dataclasses.dataclass(frozen=True)
class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=every_k)``."""

    inner: object
    every_k: int

    def init(self, module: torch.nn.Module) -> MultiStepsState:
        return MultiStepsState(0, 0, self.inner.init(module),
                               {n: torch.zeros_like(p) for n, p in module.named_parameters()})

    @torch.no_grad()
    def step(self, module: torch.nn.Module, state: MultiStepsState,
             grads: dict | None = None) -> MultiStepsState:
        n = state.mini_step
        for name, param in module.named_parameters():
            acc = state.acc[name]
            for a, g in zip(acc.view(-1).split(CHUNK),
                            _grad(param, grads, name).reshape(-1).split(CHUNK)):
                a.copy_(a + (g.to(a.dtype) - a) / (n + 1))
        state.mini_step = (n + 1) % self.every_k
        if n == self.every_k - 1:
            self.inner.step(module, state.inner, grads=state.acc)
            for acc in state.acc.values():
                acc.zero_()
            state.gradient_step += 1
        return state


def optimizer_state_bytes(state) -> int:
    """Bytes of the tensors an optimizer state holds."""
    total = 0
    for value in vars(state).values():
        if isinstance(value, dict):
            total += sum(t.numel() * t.element_size() for t in value.values())
        elif dataclasses.is_dataclass(value):
            total += optimizer_state_bytes(value)
    return total


def make_optimizer(lr: float = 1e-5, weight_decay: float = 1e-2,
                   gradient_accumulation_steps: int = 1, state_dtype=None,
                   name: str = "adamw"):
    """AdamW or Adafactor with a constant learning rate, wrapped in
    ``MultiSteps`` when ``gradient_accumulation_steps > 1`` (see the module
    docstring)."""
    if name == "adafactor":
        opt = Adafactor(lr, weight_decay * lr)
    elif name == "adamw":
        opt = AdamW(lr, weight_decay, state_dtype)
    else:
        raise ValueError(f"unknown optimizer {name!r} (adamw | adafactor)")
    if gradient_accumulation_steps > 1:
        opt = MultiSteps(opt, gradient_accumulation_steps)
    return opt


def _mean_over(tensors, group) -> None:
    """All-reduce-average ``tensors`` in place over a process group."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(n)


def train_step(trainable: torch.nn.Module, dit, optimizer, opt_state,
               batch: dict, t_min: float, t_max: float, use_remat: bool = True,
               attn_impl: str = "kernels", grad_group=None) -> dict:
    """Loss, backward, update (in place); returns the step's metrics as 0-dim
    tensors: loss, mse, special_token_loss.  ``grad_group``: the data
    axis's process group, over which the gradients and the metrics are
    averaged before the update (each process's batch is its rows of the
    global batch, of equal size, and the loss is a mean over rows)."""
    for p in trainable.parameters():
        p.grad = None
    loss, metrics = physic_training_loss(trainable, dit, batch, t_min, t_max,
                                         use_remat=use_remat, attn_impl=attn_impl)
    loss.backward()
    metrics["loss"] = loss.detach()
    if grad_group is not None:
        for p in trainable.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _mean_over([p.grad for p in trainable.parameters()] + list(metrics.values()),
                   grad_group)
    optimizer.step(trainable, opt_state)
    return metrics

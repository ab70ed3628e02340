"""AdamW and the training step (``physicedit_tpu/train/train_step.py``).

:func:`make_optimizer` gives the JAX package's AdamW with a constant
learning rate, in its two storage modes:

- ``state_dtype=None``: ``optax.adamw`` (fp32 moments; the decoupled decay is
  added to the Adam update, eps outside the bias-corrected square root);
- ``state_dtype=torch.bfloat16``: ``scale_by_adam_low_memory`` +
  ``add_decayed_weights`` + ``scale(-lr)``: the same fp32 arithmetic every
  step, the moments rounded to bf16 after each update (half the state).

Each parameter is updated in place, in chunks of at most ``CHUNK``
elements (the arithmetic is elementwise, so the chunks change nothing but
the size of the fp32 temporaries: the largest LoRA factor at rank 128 is
141 M elements); the expressions keep optax's order of operations.
Adafactor and gradient accumulation are not ported yet.
"""

from __future__ import annotations

import dataclasses

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
    def step(self, module: torch.nn.Module, state: AdamState) -> AdamState:
        """Apply one update from each parameter's ``.grad`` (a parameter
        without one counts as a zero gradient, as in JAX)."""
        state.count += 1
        b1, b2, eps = self.b1, self.b2, self.eps
        params = dict(module.named_parameters())
        dev = next(iter(params.values())).device
        c = torch.tensor(float(state.count), dtype=torch.float32, device=dev)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=dev) ** c   # fp32, as optax
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=dev) ** c
        for name, param in params.items():
            grad = param.grad if param.grad is not None else torch.zeros_like(param)
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


def make_optimizer(lr: float = 1e-5, weight_decay: float = 1e-2,
                   gradient_accumulation_steps: int = 1, state_dtype=None,
                   name: str = "adamw") -> AdamW:
    """AdamW with a constant learning rate (see the module docstring)."""
    if name == "adafactor":
        raise NotImplementedError("optimizer='adafactor' is not ported; use 'adamw'")
    if name != "adamw":
        raise ValueError(f"unknown optimizer {name!r} (adamw | adafactor)")
    if gradient_accumulation_steps > 1:
        raise NotImplementedError("gradient_accumulation_steps > 1 is not ported")
    return AdamW(lr, weight_decay, state_dtype)


def train_step(trainable: torch.nn.Module, dit, optimizer: AdamW, opt_state: AdamState,
               batch: dict, t_min: float, t_max: float, use_remat: bool = True) -> dict:
    """Loss, backward, update (in place); returns the step's metrics as 0-dim
    tensors: loss, mse, special_token_loss."""
    for p in trainable.parameters():
        p.grad = None
    loss, metrics = physic_training_loss(trainable, dit, batch, t_min, t_max,
                                         use_remat=use_remat)
    loss.backward()
    optimizer.step(trainable, opt_state)
    metrics["loss"] = loss.detach()
    return metrics

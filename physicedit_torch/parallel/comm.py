"""Collectives over one axis of the mesh, as ``torch.autograd.Function``s.

The JAX package never names a collective: GSPMD inserts them from the
shardings.  The port is multi-process SPMD (one process per GPU, launched by
``torchrun``), so the model code calls these where GSPMD would have put
one.  Each takes a ``torch.distributed`` process group (one axis of a
``DeviceMesh``, ``mesh.get_group(axis)``):

- :func:`copy_to` / :func:`reduce_from`: Megatron's conjugate pair.  The
  first is the identity forward and an all-reduce of the gradient, and goes
  before a column-split layer; the second is an all-reduce forward and the
  identity backward, and goes after a row-split layer.
- :func:`gather` / :func:`scatter`: an all-gather along a dim whose backward
  keeps this rank's slice, and its conjugate, this rank's slice whose
  backward all-gathers.  Both assume that what follows the gather (or
  precedes the scatter) is computed alike on every rank of the group, as in
  a tensor-parallel model, so the incoming gradient is whole.
- :func:`heads_to_seq` / :func:`seq_to_heads`: one ``all_to_all_single``
  that trades a split of the heads for a split of the sequence, and back.

:func:`ring_send_recv` posts one hop of a ring (rank + 1 of the group).
With a group of one rank every function is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (no
    gradient).  Every rank's x must have the same shape."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _local(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _local(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _local(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None


def copy_to(x, group):
    return x if dist.get_world_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if dist.get_world_size(group) == 1 else _ReduceFrom.apply(x, group)


def gather(x, dim: int, group):
    return x if dist.get_world_size(group) == 1 else _Gather.apply(x, dim, group)


def scatter(x, dim: int, group):
    return x if dist.get_world_size(group) == 1 else _Scatter.apply(x, dim, group)


def _a2a_heads_to_seq(x, group):
    """[B, N/n, S, D] (this rank's heads, every position) -> [B, N, S/n, D]
    (every head, this rank's positions)."""
    n = dist.get_world_size(group)
    b, h, s, d = x.shape
    send = x.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j]: rank j's heads at this rank's positions
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * h, s // n, d)


def _a2a_seq_to_heads(x, group):
    """[B, N, S/n, D] -> [B, N/n, S, D], the inverse of :func:`_a2a_heads_to_seq`."""
    n = dist.get_world_size(group)
    b, h, s, d = x.shape
    send = x.reshape(b, n, h // n, s, d).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j]: this rank's heads at rank j's positions
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a_heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a_seq_to_heads(g, ctx.group), None


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a_seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a_heads_to_seq(g, ctx.group), None


def heads_to_seq(x, group):
    """[B, N/n, S, D] -> [B, N, S/n, D] over the group (S divisible by n)."""
    return x if dist.get_world_size(group) == 1 else _HeadsToSeq.apply(x, group)


def seq_to_heads(x, group):
    """[B, N, S/n, D] -> [B, N/n, S, D] over the group (N divisible by n)."""
    return x if dist.get_world_size(group) == 1 else _SeqToHeads.apply(x, group)


def ring_send_recv(tensors, group):
    """Post one hop of the ring: each tensor (contiguous, left untouched
    until the works are waited on) goes to rank + 1 of the group and its
    counterpart comes from rank - 1.  Returns (pending, received): the
    received tensors are valid after ``wait_all(pending)``, which also
    holds the sent tensors until then."""
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    nxt, prv = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, r, prv, group) for r in recv])
    return (dist.batch_isend_irecv(ops), list(tensors)), recv


def wait_all(pending) -> None:
    works, _sent = pending
    for w in works:
        w.wait()

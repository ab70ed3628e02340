"""Sequence-parallel ring attention and Ulysses attention over
``torch.distributed`` (``physicedit_tpu/parallel/ring_attention.py``).

The sequence axis of the joint attention is split over one axis of the
mesh.  Each rank keeps its queries; the K/V chunks (with the key mask and
the bias columns they need) travel around the ring, one hop per rank of the
group, sent to rank + 1 by ``batch_isend_irecv`` (``comm.ring_send_recv``).
The next hop's transfer is posted before the current chunk's kernel runs.

Two lanes, as in the JAX package:

- ``"kernels"`` (JAX ``"pallas"``; the default on CUDA with head_dim 128):
  every hop is kernel K1 (``kernels/flash_attention.fixedmax_attention``
  with ``return_l``, ``clamp=True`` as JAX's ``_fixedmax_bnsd_lse``
  defaults).  The fixed-max softmax has no running max, so partials add with
  no rescale: ``acc += out_c * l_c``, ``l += l_c``, and ``acc / max(l,
  1e-30)`` at the end.  The lane is differentiable: its backward is a
  second ring in which every hop is kernel K8
  (``fixedmax_attention_bwd``) fed the global ``out`` and ``l``, dq
  accumulates at home and the dk / dv partials travel with their chunk,
  home after n hops.  A ring call launches K1 n times on each rank, its
  backward K8 n times.
- ``"dense"`` (JAX ``"xla"``): online-softmax chunks in torch ops, with a
  running max and rescale.  A biased call (EliGen) takes it, as in JAX: the
  bias is ``[B, S/n, S]``, this rank's query rows against every key, and
  hop t reads the columns of chunk (r - t) mod n.  Its backward is the same
  second ring over the saved running max and sum.

Each lane's arithmetic is one hop function of (running state, current
chunk): :func:`fixedmax_hop` / :func:`fixedmax_bwd_hop` and
:func:`online_hop` / :func:`online_bwd_hop`.  The ``torch.distributed`` ring
calls them once per hop; :func:`virtual_ring_fixedmax` calls the same
functions for n ranks in one process (the single-card check).

:func:`sequence_parallel_attention` is the DiT's entry (``attn_impl="ring"``):
it pads the full sequence to a multiple of the axis, masks the pads, takes
this rank's rows, runs the ring and all-gathers the output; with the heads
split over the same axis (tensor parallelism) it trades heads for sequence
with one ``all_to_all`` each way instead, where JAX's GSPMD reshards.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from physicedit_torch.kernels.flash_attention import (_fixedmax_prescaled, _prescale,
                                                      fixedmax_attention_bwd)
from physicedit_torch.ops.attention import NEG_INF, sdpa_bnsd
from physicedit_torch.parallel import comm


# ---------------------------------------------------------------------------
# The hops
# ---------------------------------------------------------------------------

def fixedmax_hop(qs, state, chunk) -> None:
    """The kernels lane's forward hop: K1 on the chunk (q prescaled, the
    clamp on), its partial added into ``state = (acc fp32 [B, N, Sq, D],
    l fp32 [B, N, Sq])`` in place.  chunk = (k, v, key_mask or None)."""
    acc, l = state
    k, v, mask = chunk
    out_c, l_c = _fixedmax_prescaled(qs, k, v, mask, True, return_l=True)
    acc.add_(out_c.float() * l_c[..., None])
    l.add_(l_c)


def fixedmax_finish(q, state):
    acc, l = state
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def fixedmax_bwd_hop(qs, g, out, l, dq, chunk):
    """The kernels lane's backward hop: K8 on the chunk with the global
    ``out`` and ``l``; dq' is added into ``dq`` (fp32) in place, and the
    chunk's (dk, dv) partials are returned in fp32."""
    k, v, mask = chunk
    dq_c, dk_c, dv_c = fixedmax_attention_bwd(qs, k, v, mask, g, out, l, True)
    dq.add_(dq_c.float())
    return dk_c.float(), dv_c.float()


def _dense_logits(q, k, mask, bias_c, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias_c is not None:
        s = s + bias_c[:, None].float()
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    return s


def online_hop(q, state, chunk, bias_c=None) -> None:
    """The dense lane's forward hop (JAX ``_chunk_attention_stats`` and the
    combine): state = (o fp32 [B, N, Sq, D], m, l fp32 [B, N, Sq, 1]),
    updated in place.  bias_c: this chunk's bias columns [B, Sq, Sc]
    (natural-log units) or None."""
    o_acc, m_acc, l_acc = state
    k, v, mask = chunk
    s = _dense_logits(q, k, mask, bias_c, 1.0 / q.shape[-1] ** 0.5)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype), v).float()
    m_new = torch.maximum(m_acc, m)
    a_acc, a = torch.exp(m_acc - m_new), torch.exp(m - m_new)
    o_acc.mul_(a_acc).add_(o * a)
    l_acc.mul_(a_acc).add_(l * a)
    m_acc.copy_(m_new)


def online_finish(q, state):
    o, _, l = state
    return (o / l.clamp(min=1e-30)).to(q.dtype)


def online_bwd_hop(q, g, out, m, l, dq, chunk, bias_c=None):
    """The dense lane's backward hop: P = exp(s - m) / l from the saved
    running max and sum, dq added into ``dq`` in place, the chunk's (dk, dv)
    returned (fp32).  Masked keys pass no gradient, as JAX's ``where``."""
    k, v, mask = chunk
    scale = 1.0 / q.shape[-1] ** 0.5
    p = torch.exp(_dense_logits(q, k, mask, bias_c, scale) - m) / l.clamp(min=1e-30)
    gf = g.float()
    dd = (gf * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(gf, v.float().transpose(-1, -2)) - dd)
    if mask is not None:
        ds = ds.masked_fill(~mask[:, None, None, :], 0.0)
    dq.add_(torch.matmul(ds, k.float()) * scale)
    return torch.matmul(ds.transpose(-1, -2), q.float()) * scale, torch.matmul(
        p.transpose(-1, -2), gf)


# ---------------------------------------------------------------------------
# The ring over a process group
# ---------------------------------------------------------------------------

def _chunk_index(group, t: int) -> int:
    """The chunk a rank holds at hop t: chunk (r - t) mod n."""
    return (dist.get_rank(group) - t) % dist.get_world_size(group)


def _ring_forward(hop, chunk, group) -> None:
    """hop(chunk, c) once per hop; the chunk goes on to rank + 1, the next
    transfer posted before the hop runs."""
    n = dist.get_world_size(group)
    for t in range(n):
        if t < n - 1:
            works, nxt = comm.ring_send_recv(chunk, group)
        hop(chunk, _chunk_index(group, t))
        if t < n - 1:
            comm.wait_all(works)
            chunk = nxt


def _ring_backward(hop, chunk, travel, group):
    """hop(chunk, c) -> the chunk's gradient partials, added to ``travel``,
    which goes around with the chunk: after n hops (and n transfers) each
    rank holds its own chunk's sums."""
    n = dist.get_world_size(group)
    for t in range(n):
        if t < n - 1:
            works, nxt = comm.ring_send_recv(chunk, group)
        travel = [a + p for a, p in zip(travel, hop(chunk, _chunk_index(group, t)))]
        if n > 1:
            t_works, travel = comm.ring_send_recv(travel, group)
            comm.wait_all(t_works)
        if t < n - 1:
            comm.wait_all(works)
            chunk = nxt
    return travel


def _chunk_tensors(k, v, mask):
    return [k, v] + ([] if mask is None else [mask])


def _as_chunk(tensors, has_mask):
    return tensors[0], tensors[1], tensors[2] if has_mask else None


def _bias_cols(bias, c, chunk):
    return None if bias is None else bias[:, :, c * chunk:(c + 1) * chunk]


class _RingFixedMax(torch.autograd.Function):
    """The kernels lane on the prescaled q' (like ``_FixedMaxAttention``:
    the gradient returned is the one of q', autograd's multiply by the
    prescale gives q's)."""

    @staticmethod
    def forward(ctx, qs, k, v, mask, group):
        state = (torch.zeros(qs.shape, dtype=torch.float32, device=qs.device),
                 torch.zeros(qs.shape[:-1], dtype=torch.float32, device=qs.device))
        has_mask = mask is not None
        _ring_forward(lambda ch, c: fixedmax_hop(qs, state, _as_chunk(ch, has_mask)),
                      _chunk_tensors(k, v, mask), group)
        out = fixedmax_finish(qs, state)
        ctx.save_for_backward(qs, k, v, out, state[1])
        ctx.mask, ctx.group = mask, group
        return out

    @staticmethod
    def backward(ctx, g):
        qs, k, v, out, l = ctx.saved_tensors
        mask, g = ctx.mask, g.contiguous()
        dq = torch.zeros(qs.shape, dtype=torch.float32, device=qs.device)
        zero = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dk, dv = _ring_backward(
            lambda ch, c: fixedmax_bwd_hop(qs, g, out, l, dq, _as_chunk(ch, mask is not None)),
            _chunk_tensors(k, v, mask), [zero, zero.clone()], ctx.group)
        return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


class _RingOnline(torch.autograd.Function):
    """The dense lane (online softmax), with an optional bias [B, Sq, S]."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bias, group):
        b, n, sq, d = q.shape
        state = (torch.zeros((b, n, sq, d), dtype=torch.float32, device=q.device),
                 torch.full((b, n, sq, 1), NEG_INF, dtype=torch.float32, device=q.device),
                 torch.zeros((b, n, sq, 1), dtype=torch.float32, device=q.device))
        has_mask, sc = mask is not None, k.shape[2]
        _ring_forward(lambda ch, c: online_hop(q, state, _as_chunk(ch, has_mask),
                                               _bias_cols(bias, c, sc)),
                      _chunk_tensors(k, v, mask), group)
        out = online_finish(q, state)
        ctx.save_for_backward(q, k, v, out, state[1], state[2])
        ctx.mask, ctx.bias, ctx.group = mask, bias, group
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        mask, bias, sc = ctx.mask, ctx.bias, k.shape[2]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        zero = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dk, dv = _ring_backward(
            lambda ch, c: online_bwd_hop(q, g, out, m, l, dq, _as_chunk(ch, mask is not None),
                                         _bias_cols(bias, c, sc)),
            _chunk_tensors(k, v, mask), [zero, zero.clone()], ctx.group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def default_ring_impl(q) -> str:
    """``"kernels"`` on CUDA with head_dim 128 (JAX picks ``"pallas"`` on the
    TPU with head_dim 128), else ``"dense"``."""
    return "kernels" if q.is_cuda and q.shape[-1] == 128 else "dense"


def _ring_attention_group(q, k, v, key_mask, group, impl: str | None = None, bias=None):
    """:func:`ring_attention` over a process group."""
    if bias is not None:
        impl = "dense"
    impl = impl or default_ring_impl(q)
    mask = None if key_mask is None else key_mask.bool().contiguous()
    k, v = k.contiguous(), v.contiguous()
    if impl == "kernels":
        qs = _prescale(q)
        if q.device.type != "cpu":
            qs = qs.contiguous()
        return _RingFixedMax.apply(qs, k, v, mask, group)
    if impl == "dense":
        return _RingOnline.apply(q, k, v, mask, None if bias is None else bias.contiguous(),
                                 group)
    raise ValueError(f"unknown ring impl {impl!r} (kernels | dense)")


def ring_attention(q, k, v, key_mask, mesh, axis: str = "model", impl: str | None = None,
                   bias=None):
    """Sequence-parallel attention on this rank's shards: q/k/v [B, N, S/n,
    D], key_mask [B, S/n] bool (or None), bias [B, S/n, S] (this rank's
    query rows against every key, natural-log units) or None; returns this
    rank's rows [B, N, S/n, D].  The mesh axis's ranks hold the chunks in
    rank order.  impl: ``"kernels"`` or ``"dense"`` (see the module
    docstring); a bias forces ``"dense"``.  Differentiable in both lanes."""
    return _ring_attention_group(q, k, v, key_mask, mesh.get_group(axis), impl, bias)


def sequence_parallel_attention(q, k, v, key_mask, group, bias=None, impl: str | None = None,
                                heads_split: bool = False):
    """The full-sequence form: q/k/v [B, N', S, D] alike on every rank of
    ``group`` (or, with ``heads_split``, each rank's N' = N / n heads of a
    tensor-parallel split over the same group), key_mask [B, S] or None, bias [B, S, S] or None ->
    [B, N', S, D].  S is padded to a multiple of the group's size, the pads
    masked; this rank's rows go through the ring and the output is
    all-gathered (or traded back for heads)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b, _, s, _ = q.shape
    pad = (-s) % n
    mask = torch.ones((b, s), dtype=torch.bool, device=q.device) if key_mask is None \
        else key_mask.bool()
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        mask = F.pad(mask, (0, pad), value=False)
        if bias is not None:
            bias = F.pad(bias, (0, pad, 0, pad))
    chunk = (s + pad) // n
    rows = slice(r * chunk, (r + 1) * chunk)
    if heads_split:
        ql, kl, vl = (comm.heads_to_seq(t.contiguous(), group) for t in (q, k, v))
    else:
        ql, kl, vl = (comm.scatter(t, 2, group) for t in (q, k, v))
    out = _ring_attention_group(ql, kl, vl, mask[:, rows].contiguous(), group, impl,
                               None if bias is None else bias[:, rows])
    out = comm.seq_to_heads(out, group) if heads_split \
        else comm.gather(out, 2, group)
    return out[:, :, :s]


# ---------------------------------------------------------------------------
# n virtual ranks in one process (the single-card check of the kernels lane)
# ---------------------------------------------------------------------------

def _virtual_chunks(t, n):
    return [c.contiguous() for c in t.chunk(n, dim=-2 if t.dim() == 4 else -1)]


def virtual_ring_fixedmax(q, k, v, key_mask, n: int):
    """The kernels lane's forward for n virtual ranks in one process,
    through :func:`fixedmax_hop`: rank r holds query rows chunk r and, at
    hop t, K/V chunk (r - t) mod n.  Full-sequence inputs [B, N, S, D] (S
    divisible by n), key_mask [B, S] or None.  Returns (out, l) as one K1
    call with ``return_l`` would (n^2 K1 launches)."""
    qs = _virtual_chunks(_prescale(q), n)
    ks, vs = _virtual_chunks(k, n), _virtual_chunks(v, n)
    ms = [None] * n if key_mask is None else _virtual_chunks(key_mask, n)
    states = [(torch.zeros(c.shape, dtype=torch.float32, device=q.device),
               torch.zeros(c.shape[:-1], dtype=torch.float32, device=q.device)) for c in qs]
    for t in range(n):
        for r in range(n):
            c = (r - t) % n
            fixedmax_hop(qs[r], states[r], (ks[c], vs[c], ms[c]))
    out = torch.cat([fixedmax_finish(qs[r], states[r]) for r in range(n)], dim=2)
    return out, torch.cat([st[1] for st in states], dim=2)


def virtual_ring_fixedmax_bwd(qs, k, v, key_mask, g, out, l, n: int):
    """The kernels lane's backward for n virtual ranks through
    :func:`fixedmax_bwd_hop` (n^2 K8 launches): the gradients (dq', dk, dv)
    of K1 on the prescaled q', as one K8 call gives them; the dk / dv
    partials of chunk c are summed in the order the ring visits them."""
    split = lambda t: None if t is None else _virtual_chunks(t, n)  # noqa: E731
    qc, kc, vc, gc, oc, lc = (split(t) for t in (qs, k, v, g, out, l))
    mc = [None] * n if key_mask is None else split(key_mask)
    dq = [torch.zeros(c.shape, dtype=torch.float32, device=qs.device) for c in qc]
    dk = [torch.zeros(c.shape, dtype=torch.float32, device=k.device) for c in kc]
    dv = [torch.zeros_like(c) for c in dk]
    for t in range(n):
        for r in range(n):
            c = (r - t) % n
            pk, pv = fixedmax_bwd_hop(qc[r], gc[r], oc[r], lc[r], dq[r], (kc[c], vc[c], mc[c]))
            dk[c] = dk[c] + pk
            dv[c] = dv[c] + pv
    cat = lambda ts, like: torch.cat(ts, dim=2).to(like.dtype)  # noqa: E731
    return cat(dq, qs), cat(dk, k), cat(dv, v)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

def ulysses_attention(q, k, v, key_mask, mesh, axis: str = "model"):
    """Ulysses sequence parallelism (JAX ``ulysses_attention``): this rank's
    q/k/v [B, N, S/n, D] are traded by ``all_to_all_single`` for every
    position of N/n heads, attended densely (``sdpa_bnsd``, JAX's
    ``sdpa_bnsd``) against the all-gathered key mask, and traded back:
    returns [B, N, S/n, D].  N divisible by the axis size."""
    group = mesh.get_group(axis)
    qh, kh, vh = (comm.seq_to_heads(t.contiguous(), group) for t in (q, k, v))
    mask = None if key_mask is None else comm.all_gather_cat(key_mask.contiguous(), 1, group)
    return comm.heads_to_seq(sdpa_bnsd(qh, kh, vh, key_mask=mask), group)

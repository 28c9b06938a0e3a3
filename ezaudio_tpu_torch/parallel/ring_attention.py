"""Ring attention: exact self-attention with the sequence split over the
``sp`` mesh axis (counterpart of ``ezaudio_tpu/parallel/ring_attention.py``).

:func:`ring_attention` takes the sp group's whole (B, H, L, D) tensors, as
JAX's ``shard_map`` does.  Rank r of the group keeps its L/sp block of q,
k, v and the key mask, accumulates the online softmax of its q block
against its own k/v block in f32, then runs sp - 1 hops, each a rotation
of k, v and the mask to the next rank (``batch_isend_irecv``) followed by
an accumulate; the normalised block outputs are all-gathered along L.
Global in, global out: RoPE, the patch conv and the final conv see the
whole sequence and need no halo exchange.  The batch rows a rank holds
are already its dp rows (``shard_batch``), so ``batch_axes`` only names
them.  The per-hop blocks are plain torch matmuls, as JAX's ``_ring_body``
is a plain einsum: no kernel of the port is on the ring.

The gradient is the ring's own (torch's point-to-point ops have none): a
``torch.autograd.Function`` whose backward recomputes each hop from the
saved log-sum-exp, accumulates dQ locally, and sends dK and dV around with
their block; after the sp-th rotation they are home.  The hop, the
normalisation and the hop's backward are plain functions
(:func:`hop_accumulate`, :func:`ring_finish`, :func:`hop_backward`):
:func:`ring_blocks_forward` and :func:`ring_blocks_backward` drive them in
one process over hand-rotated blocks, in the order the ranks do.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ezaudio_tpu_torch.parallel.collectives import all_gather_cat

NEG = float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# the per-hop math
# ---------------------------------------------------------------------------

def ring_init(q: torch.Tensor):
    """The running (max, sum, accumulator) of a q block, f32."""
    B, H, Lq, D = q.shape
    return (q.new_full((B, H, Lq, 1), -NEG, dtype=torch.float32),
            q.new_zeros((B, H, Lq, 1), dtype=torch.float32),
            q.new_zeros((B, H, Lq, D), dtype=torch.float32))


def _scores(q32, k, kmask, scale: float):
    s = torch.matmul(q32, k.float().transpose(-1, -2)) * scale
    return s.masked_fill(~kmask.bool()[:, None, None, :], -NEG)


def hop_accumulate(q32, k, v, kmask, scale: float, m, l, acc):
    """One hop: the f32 q block against one k/v block and its (B, Lk)
    mask, folded into the running ``(m, l, acc)`` (JAX's ``accum``)."""
    s = _scores(q32, k, kmask, scale)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.matmul(p, v.float())
    return m_new, l_new, acc_new


def ring_finish(m, l, acc) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normalised f32 output of a q block and its log-sum-exp."""
    l = torch.clamp(l, min=1e-30)
    return acc / l, m + torch.log(l)


def hop_backward(q32, k, v, kmask, scale: float, lse, do32, delta):
    """One hop's gradients, recomputed from the log-sum-exp: (dq, dk, dv)
    of the q block against this k/v block, f32.  ``delta`` is
    ``rowsum(dO * O)`` of the q block."""
    s = _scores(q32, k, kmask, scale)
    p = torch.exp(s - lse)
    v32 = v.float()
    dv = torch.matmul(p.transpose(-1, -2), do32)
    ds = p * (torch.matmul(do32, v32.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
    return dq, dk, dv


def _blocks(x, sp, dim):
    return list(torch.chunk(x, sp, dim=dim))


def _mask(key_mask, k):
    if key_mask is None:
        return torch.ones(k.shape[0], k.shape[2], dtype=torch.bool, device=k.device)
    return key_mask.bool()


def ring_blocks_forward(q, k, v, key_mask=None, sp: int = 4, scale: Optional[float] = None):
    """The ring's forward in one process: sp blocks, rank r visiting k/v
    blocks r, r-1, ... in hop order.  Returns the output (B, H, L, D) in
    v's dtype, the f32 block outputs and their log-sum-exps."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    key_mask = _mask(key_mask, k)
    qs, ks, vs, ms = (_blocks(q, sp, 2), _blocks(k, sp, 2), _blocks(v, sp, 2),
                      _blocks(key_mask, sp, 1))
    q32 = [b.float() for b in qs]
    state = [ring_init(b) for b in qs]
    for i in range(sp):
        for r in range(sp):
            j = (r - i) % sp
            state[r] = hop_accumulate(q32[r], ks[j], vs[j], ms[j], scale, *state[r])
    outs, lses = zip(*(ring_finish(*s) for s in state))
    return torch.cat(outs, dim=2).to(v.dtype), list(outs), list(lses)


def ring_blocks_backward(q, k, v, dout, key_mask=None, sp: int = 4,
                         scale: Optional[float] = None):
    """The ring's backward in one process, in the ranks' order: at hop i
    rank r holds block (r - i) mod sp with the dK, dV that travelled with
    it.  Returns (dq, dk, dv) in the inputs' dtypes."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    key_mask = _mask(key_mask, k)
    _, outs, lses = ring_blocks_forward(q, k, v, key_mask, sp, scale)
    qs, ks, vs, ms = (_blocks(q, sp, 2), _blocks(k, sp, 2), _blocks(v, sp, 2),
                      _blocks(key_mask, sp, 1))
    dos = [b.float() for b in _blocks(dout, sp, 2)]
    deltas = [(do * o).sum(dim=-1, keepdim=True) for do, o in zip(dos, outs)]
    q32 = [b.float() for b in qs]
    dq = [torch.zeros_like(b) for b in q32]
    dk = [torch.zeros_like(b, dtype=torch.float32) for b in ks]
    dv = [torch.zeros_like(b, dtype=torch.float32) for b in vs]
    for i in range(sp):
        for r in range(sp):
            j = (r - i) % sp
            a, b, c = hop_backward(q32[r], ks[j], vs[j], ms[j], scale, lses[r], dos[r],
                                   deltas[r])
            dq[r] += a
            dk[j] += b
            dv[j] += c
    return (torch.cat(dq, 2).to(q.dtype), torch.cat(dk, 2).to(k.dtype),
            torch.cat(dv, 2).to(v.dtype))


# ---------------------------------------------------------------------------
# the distributed ring
# ---------------------------------------------------------------------------

def _rotate(tensors: List[torch.Tensor], group, ranks: Sequence[int], r: int):
    """Send each tensor to the next rank of the ring, receive the
    previous rank's."""
    sp = len(ranks)
    nxt, prv = ranks[(r + 1) % sp], ranks[(r - 1) % sp]
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, b, prv, group) for b in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale, group, ranks, r):
        sp = len(ranks)
        qb, kb, vb = (_blocks(t, sp, 2)[r].contiguous() for t in (q, k, v))
        mb = _blocks(key_mask.to(torch.uint8), sp, 1)[r].contiguous()
        q32 = qb.float()
        state = hop_accumulate(q32, kb, vb, mb, scale, *ring_init(qb))
        cur = [kb, vb, mb]
        for _ in range(sp - 1):
            cur = _rotate(cur, group, ranks, r)
            state = hop_accumulate(q32, *cur, scale, *state)
        out32, lse = ring_finish(*state)
        ctx.save_for_backward(qb, kb, vb, mb, out32, lse)
        ctx.scale, ctx.group, ctx.ranks, ctx.r = scale, group, ranks, r
        return all_gather_cat(out32.to(v.dtype), group, dim=2)

    @staticmethod
    def backward(ctx, dout):
        qb, kb, vb, mb, out32, lse = ctx.saved_tensors
        scale, group, ranks, r = ctx.scale, ctx.group, ctx.ranks, ctx.r
        sp = len(ranks)
        do32 = _blocks(dout, sp, 2)[r].float()
        delta = (do32 * out32).sum(dim=-1, keepdim=True)
        q32 = qb.float()
        dq = torch.zeros_like(q32)
        k_, v_, m_ = kb, vb, mb
        dk = torch.zeros_like(kb, dtype=torch.float32)
        dv = torch.zeros_like(vb, dtype=torch.float32)
        for i in range(sp):
            if i:
                k_, v_, m_, dk, dv = _rotate([k_, v_, m_, dk, dv], group, ranks, r)
            a, b, c = hop_backward(q32, k_, v_, m_, scale, lse, do32, delta)
            dq += a
            dk += b
            dv += c
        if sp > 1:  # the sp-th rotation brings dK and dV home
            dk, dv = _rotate([dk, dv], group, ranks, r)
        grads = [all_gather_cat(g.to(t.dtype), group, dim=2)
                 for g, t in ((dq, qb), (dk, kb), (dv, vb))]
        return (*grads, None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   key_mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                   axis: str = "sp", batch_axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Exact attention over (B, H, L, D) with L split over the mesh axis
    ``axis``: the sp group's whole tensors in, the whole output out (in
    v's dtype).  ``key_mask`` (B, Lk) True = attend rotates with its k/v
    block.  L must divide by the axis' size (an ``AssertionError``, as
    JAX asserts).  ``batch_axes``: the mesh axes the batch rows were split
    over (``shard_batch`` did that already)."""
    from ezaudio_tpu_torch.parallel.mesh import AXES

    if scale is None:
        scale = q.shape[-1] ** -0.5
    sp = int(mesh.size(AXES.index(axis)))
    if q.shape[2] % sp or k.shape[2] % sp:
        raise AssertionError(f"sequence {q.shape[2]}/{k.shape[2]} not divisible by sp={sp}")
    group = mesh.get_group(axis)
    ranks = [dist.get_global_rank(group, i) for i in range(sp)]
    return _RingAttention.apply(q, k, v, _mask(key_mask, k), float(scale), group, ranks,
                                int(mesh.get_local_rank(axis)))


# ---------------------------------------------------------------------------
# the ambient ring context
# ---------------------------------------------------------------------------

_state = threading.local()


@contextlib.contextmanager
def ring_context(mesh, axis: str = "sp", batch_axes: Optional[Sequence[str]] = None):
    """Inside it (per thread), self-attention with ``attn_impl='ring'``,
    and with ``'auto'`` when the mesh's ``axis`` is larger than 1, runs
    :func:`ring_attention` on this mesh."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, axis, tuple(batch_axes) if batch_axes else None)
    try:
        yield
    finally:
        _state.ctx = prev


def current_ring_context():
    """``(mesh, axis, batch_axes)`` of the innermost :func:`ring_context`,
    or None."""
    return getattr(_state, "ctx", None)

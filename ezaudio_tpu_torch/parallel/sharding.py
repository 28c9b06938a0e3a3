"""Apply the placements of ``parallel/mesh.py`` to a model (``shard_params``).

  * **tp** placements: Megatron tensor parallelism by hand.  A column
    split keeps this rank's output rows of the weight (q/k/v: its H/tp
    heads; the MLP's input projection: matching slices of the value and
    the gate halves of a gated activation, so that ``chunk(2)`` pairs them
    as the whole layer does); a row split keeps its input columns.  The
    weight becomes a DTensor on the tp sub-mesh, sharded on that dimension
    (for a gated projection the global view is the weight with its rows
    permuted, undone by :meth:`ShardedParams.to_full`).  The linear's
    ``tp`` attribute routes its forward: ``copy_to_group`` before a column
    split, ``reduce_from_group`` after a row split, then the bias.  The
    int8 weight is quantized from the whole weight, then sliced.
  * **fsdp** placements: FSDP2 ``fully_shard`` of the model over the
    ``(dp, fsdp)`` sub-mesh (HSDP), ``shard_placement_fn`` giving each
    parameter its dimension; every other parameter is in
    ``ignored_params``.
  * replicated parameters (and the tp-split ones, which JAX replicates
    over dp and fsdp) keep their gradients local; :meth:`reduce_grads`
    averages them over dp x fsdp, after summing over tp the ones a tp rank
    only sees part of (the per-head q/k norms, the biases and snake
    parameters of a column split).

Gradients come from ``loss.backward()`` (FSDP2 reduces its parameters'
there), :meth:`ShardedParams.grads`.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from ezaudio_tpu_torch.parallel.mesh import (Placement, axis_rank, axis_size, data_group,
                                             data_world, dit_param_shardings, param_shardings,
                                             tp_role)


class TPInfo(NamedTuple):
    """A linear's tensor-parallel split: ``role`` 'col' or 'row', the tp
    ``group``, ``index`` (this rank's output rows for 'col', input columns
    for 'row', of the whole weight) and the whole layer's sizes."""
    role: str
    group: object
    index: torch.Tensor
    in_features: int
    out_features: int


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor as it is."""
    return t.to_local() if _is_dtensor(t) else t


def _flat_all_reduce(tensors: List[torch.Tensor], group, scale: Optional[float] = None):
    """Sum ``tensors`` over ``group`` in place in one collective; times
    ``scale`` after."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale is not None:
        flat.mul_(scale)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off: off + n].view_as(t))
        off += n


class ShardedParams:
    """A model placed on a mesh: what :func:`shard_params` did, the
    gradient reduction it needs, and the conversions between its shards
    and the unsharded (single-device) layout of checkpoints."""

    def __init__(self, mesh, model: nn.Module, placements: Dict[str, Placement]):
        self.mesh, self.model, self.placements = mesh, model, placements
        self.tp_partial: set = set()   # replicated, but a tp rank sees part of the use
        self.perm: Dict[str, torch.Tensor] = {}  # gated projections' row order
        self.fsdp_names = {n for n, pl in placements.items() if pl.axis == "fsdp"}
        self.wrapped = False

    # -- gradients -----------------------------------------------------
    def grads(self, loss: torch.Tensor, named_params: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """``d loss / d param`` of ``named_params`` for the mean loss of
        the whole batch, where ``loss`` is this rank's mean over its rows:
        ``backward`` (FSDP2 averages its parameters' gradients there), then
        :meth:`reduce_grads`; zeros where the loss does not reach."""
        params = list(named_params.values())
        for p in params:
            p.grad = None
        loss.backward()
        out = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
               for n, p in named_params.items()}
        for p in params:
            p.grad = None
        self.reduce_grads(out)
        return out

    @torch.no_grad()
    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """In place: the tp-partial gradients summed over tp, then every
        gradient FSDP2 did not reduce averaged over dp x fsdp."""
        if axis_size(self.mesh, "tp") > 1:
            part = [local(grads[n]) for n in grads if n in self.tp_partial]
            _flat_all_reduce(part, self.mesh.get_group("tp"))
        world = data_world(self.mesh)
        if world > 1:
            rest = [local(g) for n, g in grads.items() if n not in self.fsdp_names]
            _flat_all_reduce(rest, data_group(self.mesh), 1.0 / world)

    # -- the unsharded layout -----------------------------------------
    def to_full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The unsharded value of parameter ``name``'s tensor ``t`` (the
        parameter itself, a gradient or an optimizer moment): gathered
        from its shards, a gated projection's rows put back in order.
        A collective for a DTensor: every rank calls it, in one order."""
        if _is_dtensor(t):
            t = t.full_tensor()
        perm = self.perm.get(name)
        if perm is not None and t.ndim >= 1 and t.shape[0] == perm.numel():
            t = t[torch.argsort(perm.to(t.device))]
        return t

    def from_full(self, name: str, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """``full`` (unsharded layout) as ``like`` holds it: permuted and
        cut to this rank's shard, a DTensor where ``like`` is one."""
        from torch.distributed.tensor import distribute_tensor

        full = full.to(device=like.device, dtype=like.dtype)
        perm = self.perm.get(name)
        if perm is not None and full.ndim >= 1 and full.shape[0] == perm.numel():
            full = full[perm.to(full.device)]
        if _is_dtensor(like):
            return distribute_tensor(full, like.device_mesh, like.placements,
                                     src_data_rank=None)
        return full

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict in the unsharded layout, on every rank."""
        sd = {}
        for name, t in list(self.model.named_parameters()) + list(self.model.named_buffers()):
            sd[name] = self.to_full(name, t.detach())
        return {k: sd[k] for k in self.model.state_dict()}

    @torch.no_grad()
    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load an unsharded state dict (strict) into the shards."""
        every = dict(list(self.model.named_parameters()) + list(self.model.named_buffers()))
        names = {k: every[k] for k in self.model.state_dict()}
        missing = set(names) - set(sd)
        unexpected = set(sd) - set(names)
        if missing or unexpected:
            raise KeyError(f"state dict mismatch: missing {sorted(missing)[:5]}, "
                           f"unexpected {sorted(unexpected)[:5]}")
        for name, t in names.items():
            local(t).copy_(local(self.from_full(name, sd[name], t)))


def _gated(model: nn.Module, linear_name: str) -> bool:
    """Whether the linear is a gated activation's input projection
    (value and gate halves, ``chunk(2)``)."""
    parent = linear_name.rsplit(".", 1)[0]
    return getattr(dict(model.named_modules()).get(parent), "mult", 1) == 2


@torch.no_grad()
def _apply_tp(sh: ShardedParams) -> None:
    from torch.distributed.tensor import DTensor, Shard

    from ezaudio_tpu_torch.ops.quant import quantize_symmetric

    mesh, model = sh.mesh, sh.model
    tp, r = axis_size(mesh, "tp"), axis_rank(mesh, "tp")
    tp_mesh = mesh["tp"]
    group = tp_mesh.get_group()
    modules = dict(model.named_modules())
    for name, pl in sh.placements.items():
        if pl.axis != "tp":
            continue
        mname = name.rsplit(".", 1)[0]
        lin = modules[mname]
        role = tp_role(name)
        W = lin.weight.detach()
        n = W.shape[0] if role == "col" else W.shape[1]
        dev = W.device
        if role == "col" and _gated(model, mname):
            half = n // 2
            if half % tp:
                raise NotImplementedError(f"{mname}: the gated halves ({half}) do not divide "
                                          f"by tp={tp}")
            k = half // tp
            inner = torch.arange(r * k, (r + 1) * k, device=dev)
            idx = torch.cat([inner, half + inner])
            sh.perm[name] = torch.cat([torch.cat([torch.arange(q * k, (q + 1) * k),
                                                  half + torch.arange(q * k, (q + 1) * k)])
                                       for q in range(tp)])
            act = modules[mname.rsplit(".", 1)[0]]
            act.tp_inner = inner
            for pname in ("alpha", "beta"):
                if getattr(act, pname, None) is not None:
                    sh.tp_partial.add(f"{mname.rsplit('.', 1)[0]}.{pname}")
        else:
            k = n // tp
            idx = torch.arange(r * k, (r + 1) * k, device=dev)
        if role == "col":
            parent = modules[mname.rsplit(".", 1)[0]]
            heads = getattr(parent, "num_heads", None)
            if mname.rsplit(".", 1)[-1] in ("to_q", "to_k", "to_v") and heads % tp:
                raise NotImplementedError(f"{mname}: {heads} heads do not divide by tp={tp}")
            for norm in ("norm_q", "norm_k"):
                m = getattr(parent, norm, None)
                if m is not None:
                    sh.tp_partial.update(f"{mname.rsplit('.', 1)[0]}.{norm}.{p}"
                                         for p, _ in m.named_parameters())
            if lin.bias is not None:
                sh.tp_partial.add(f"{mname}.bias")
        # int8: quantized from the whole weight (the JAX package quantizes
        # its global parameter), then sliced
        key = lin._weight_key() if hasattr(lin, "_weight_key") else None
        wq = getattr(lin, "_wq", None)
        if wq is None or lin._wq_key != key:
            wq = quantize_symmetric(W.float(), -1)
        local_w = (W[idx] if role == "col" else W[:, idx]).contiguous()
        dt = DTensor.from_local(local_w, tp_mesh, [Shard(0 if role == "col" else 1)],
                                run_check=False)
        lin.weight = nn.Parameter(dt, requires_grad=lin.weight.requires_grad)
        lin.tp = TPInfo(role, group, idx, W.shape[1], W.shape[0])
        lin._wq = (wq[0][idx], wq[1][idx]) if role == "col" else (wq[0][:, idx], wq[1])
        lin._wq_key = lin._weight_key()


def shard_params(mesh, model: nn.Module, placements: Optional[Dict[str, Placement]] = None
                 ) -> ShardedParams:
    """Place ``model``'s parameters on ``mesh`` by ``placements`` (default
    :func:`param_shardings`); see the module docstring.  Returns the
    :class:`ShardedParams` a trainer reduces gradients and writes
    checkpoints through."""
    placements = placements if placements is not None else param_shardings(mesh, model)
    sh = ShardedParams(mesh, model, placements)
    if axis_size(mesh, "tp") > 1:
        _apply_tp(sh)
    if sh.fsdp_names:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        dims = {p: placements[n].dim for n, p in model.named_parameters()
                if n in sh.fsdp_names}
        ignored = {p for n, p in model.named_parameters() if n not in sh.fsdp_names}
        fully_shard(model, mesh=mesh["dp", "fsdp"],
                    shard_placement_fn=lambda p: Shard(dims[p]), ignored_params=ignored)
        sh.wrapped = True
    return sh


def shard_dit(mesh, model: nn.Module) -> ShardedParams:
    """A (Mask)DiT on ``mesh`` by :func:`dit_param_shardings`."""
    return shard_params(mesh, model, dit_param_shardings(mesh, model))

"""Process groups, the device mesh and the sharding rules (counterpart of
``ezaudio_tpu/parallel/mesh.py``).

One process per GPU (``torchrun``'s environment, or an explicit
``init_method``), and a ``torch.distributed.device_mesh.DeviceMesh`` over the
world with the JAX package's axes, outermost first:

  * ``dp``: batch rows (prompts, and the CFG pair at inference);
  * ``fsdp``: batch rows too, and ZeRO-style parameter sharding: each
    parameter's largest divisible axis is sharded, through FSDP2
    (``fully_shard`` over the ``(dp, fsdp)`` sub-mesh: HSDP, replicated
    over dp and sharded over fsdp);
  * ``tp``: Megatron tensor parallelism of the DiT (q/k/v and the MLP's
    input projection split by output, the attention's and the MLP's
    output projections by input; ``dit_param_shardings``);
  * ``sp``: sequence parallelism, innermost: self-attention as an exact
    ring over the sp group (``parallel/ring_attention.py``).

Where JAX places a global array on the mesh, each rank here holds what its
devices would hold: its rows of a batch (:func:`shard_batch`), a whole copy
of a replicated tensor, a shard of a sharded parameter.  Results that JAX
returns as global arrays are gathered back (``gather_rows``).  Every
process group gets ``PG_TIMEOUT``, so a collective that hangs fails.

The placement rules (:func:`param_shardings`, :func:`dit_param_shardings`)
are JAX's, computed on each parameter's JAX layout (a linear's kernel is
(in, out), a conv's (K, in, out)) and mapped to the torch dimension they
shard: ``Placement(spec, axis, dim)`` holds the JAX ``PartitionSpec``
entries, the mesh axis sharding the parameter (or None) and its torch
dimension.  :func:`shard_params` applies them.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ezaudio_tpu_torch.parallel.collectives import all_gather_cat

AXES = ("dp", "fsdp", "tp", "sp")
PG_TIMEOUT = timedelta(seconds=60)


# ---------------------------------------------------------------------------
# process groups and the mesh
# ---------------------------------------------------------------------------

def init_distributed(device=None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout: timedelta = PG_TIMEOUT) -> torch.device:
    """Join the process group and return this rank's device.

    NCCL when the device is CUDA (``cuda:LOCAL_RANK``, made current), gloo
    on the CPU; a card never falls back to gloo.  Without ``init_method``
    the group is read from torchrun's environment (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  Joining twice
    returns the device and changes nothing."""
    from ezaudio_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank or 0))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if rank is not None:
            kw.update(rank=rank, world_size=world_size)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method or "env://", timeout=timeout,
                                **({"device_id": dev} if dev.type == "cuda" else {}), **kw)
    return dev


def mesh_shape(n: int, dp: Optional[int] = None, fsdp: int = 1, tp: int = 1,
               sp: int = 1) -> Tuple[int, int, int, int]:
    """``(dp, fsdp, tp, sp)`` over ``n`` ranks, ``dp=None`` taking what is
    left; JAX's assertions."""
    if dp is None:
        if n % (fsdp * tp * sp) != 0:
            raise AssertionError(f"{n} devices do not divide into fsdp={fsdp} x tp={tp} "
                                 f"x sp={sp}")
        dp = n // (fsdp * tp * sp)
    if dp * fsdp * tp * sp != n:
        raise AssertionError(f"mesh {dp}x{fsdp}x{tp}x{sp} != {n} devices")
    return dp, fsdp, tp, sp


def make_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1, sp: int = 1):
    """A ``(dp, fsdp, tp, sp)`` DeviceMesh over the initialised world
    (:func:`init_distributed` first); ``sp`` innermost, so a ring's
    neighbours are adjacent ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    shape = mesh_shape(dist.get_world_size(), dp, fsdp, tp, sp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=AXES)
    for axis in AXES:  # the mesh's own groups take torch's defaults (10-30 min)
        dist.distributed_c10d._set_pg_timeout(PG_TIMEOUT, mesh.get_group(axis))
    return mesh


def check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != AXES:
        raise TypeError(f"mesh must be a DeviceMesh with dims {AXES} (make_mesh), "
                        f"got {mesh!r}")


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else int(mesh.size(AXES.index(axis)))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def data_world(mesh) -> int:
    """The data-parallel world: dp x fsdp, the ways the batch splits."""
    return axis_size(mesh, "dp") * axis_size(mesh, "fsdp")


def data_rank(mesh) -> int:
    """This rank's place among the batch shards (row-major over dp, fsdp)."""
    return axis_rank(mesh, "dp") * axis_size(mesh, "fsdp") + axis_rank(mesh, "fsdp")


def subgroup(mesh, axes: Sequence[str]):
    """The process group of this rank over the mesh ``axes`` together (the
    other axes fixed), created on first use by every rank at once and kept
    on the mesh."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_ezaudio_subgroups", {})
    if axes not in groups:
        grid = mesh.mesh.numpy()
        keep = [AXES.index(a) for a in axes]
        rest = [i for i in range(len(AXES)) if i not in keep]
        rows = np.transpose(grid, rest + keep).reshape(
            -1, int(np.prod([grid.shape[i] for i in keep])))
        groups[axes], _ = dist.new_subgroups_by_enumeration(
            [list(map(int, r)) for r in rows], timeout=PG_TIMEOUT)
    return groups[axes]


def data_group(mesh):
    return subgroup(mesh, ("dp", "fsdp"))


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, str):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, tree, strict: bool = True):
    """This rank's rows of every array of ``tree`` (tensors and numpy
    arrays; other leaves as they are): the leading axis split over dp x
    fsdp, each rank its contiguous block.  An array whose leading axis is
    at least the data world but does not divide raises ``ValueError``
    unless ``strict=False`` (it would be replicated, a silent waste);
    smaller arrays (a shared uncond embedding) are replicated."""
    world, r = data_world(mesh), data_rank(mesh)

    def put(x):
        if not hasattr(x, "ndim") or x.ndim < 1:
            return x
        n = x.shape[0]
        if n % world == 0:
            k = n // world
            return x[r * k:(r + 1) * k]
        if strict and n >= world:
            raise ValueError(
                f"shard_batch: leading axis {n} is not divisible by the dp world size "
                f"{world}; this would silently replicate the batch across the mesh. Pad "
                "the batch or pass strict=False to replicate intentionally.")
        return x

    return _map(put, tree)


def gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """The rows of every batch shard, in order: the inverse of
    :func:`shard_batch` on a divisible batch."""
    return all_gather_cat(x, data_group(mesh), dim=0)


@torch.no_grad()
def replicate(mesh, tree):
    """Every rank holds rank 0's values: the tensors of ``tree`` (or the
    parameters and buffers of a module) are broadcast in place from the
    world's rank 0; returns ``tree``."""
    if mesh is None or dist.get_world_size() == 1:
        return tree
    leaves: List[torch.Tensor] = []
    if isinstance(tree, nn.Module):
        leaves = [t.data for t in list(tree.parameters()) + list(tree.buffers())]
    else:
        _map(lambda x: leaves.append(x) if isinstance(x, torch.Tensor) else None, tree)
    for t in leaves:
        buf = t.contiguous()
        dist.broadcast(buf, src=0)
        if buf is not t:
            t.copy_(buf)
    return tree


class activation_sharding:
    """JAX's trace-time pin of block activations to batch sharding.  Here
    every rank holds only its batch rows already, so there is nothing to
    pin: entering it records the mesh and :func:`constrain_batch` is the
    identity.  As in JAX it refuses an sp > 1 mesh."""

    def __init__(self, mesh, batch_axes: Sequence[str] = ("dp", "fsdp")):
        if axis_size(mesh, "sp") != 1:
            raise AssertionError("activation_sharding is batch-only; sp meshes use "
                                 "ring_context")
        self.mesh, self.batch_axes = mesh, tuple(batch_axes)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def constrain_batch(x):
    """The identity: a rank's activations are its batch rows already."""
    return x


# ---------------------------------------------------------------------------
# placement rules
# ---------------------------------------------------------------------------

class Placement(NamedTuple):
    spec: Tuple[Optional[str], ...]  # JAX's PartitionSpec entries, JAX layout
    axis: Optional[str]              # 'fsdp', 'tp' or None (replicated)
    dim: Optional[int]               # the torch dimension ``axis`` shards


REPLICATED = Placement((), None, None)


def jax_layout(name: str, shape: Sequence[int]) -> Tuple[Tuple[int, ...], List[int]]:
    """The JAX layout of the port parameter ``name`` of torch ``shape``:
    its JAX shape and, for each JAX axis, the torch dimension it maps to
    (``convert/from_jax.py`` in reverse).  A linear's (out, in) weight is
    JAX's (in, out) kernel; a conv's (out, in, *k) weight is (*k, in, out),
    and the patch embedding is one (k*in, out) kernel (its JAX axis 0 maps
    to the torch input-channel dimension); ``weight_g`` is a vector."""
    shape = tuple(int(s) for s in shape)
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight_g":
        return (int(np.prod(shape)),), [0]
    if leaf in ("weight", "weight_v") and len(shape) >= 2:
        if len(shape) == 2:
            return (shape[1], shape[0]), [1, 0]
        k = list(range(2, len(shape)))
        if name.endswith("patch_embed.proj.weight"):
            return (int(np.prod(shape[1:])), shape[0]), [1, 0]
        return tuple(shape[i] for i in k) + (shape[1], shape[0]), k + [1, 0]
    return shape, list(range(len(shape)))


def _fsdp_axis(shape: Tuple[int, ...], fsdp: int) -> Optional[int]:
    """JAX's ``_fsdp_spec``: the largest axis that divides (ties to the
    later axis), never a vector's."""
    if fsdp == 1 or len(shape) < 2:
        return None
    for i in sorted(range(len(shape)), key=lambda i: (-shape[i], -i)):
        if shape[i] % fsdp == 0 and shape[i] >= 2 * fsdp:
            return i
    return None


def _placement(name, shape, axis_name, jax_axis) -> Placement:
    jshape, dims = jax_layout(name, shape)
    if jax_axis is None:
        return REPLICATED
    spec = [None] * len(jshape)
    spec[jax_axis] = axis_name
    return Placement(tuple(spec), axis_name, dims[jax_axis])


def param_shardings(mesh, model: nn.Module) -> Dict[str, Placement]:
    """fsdp placements for every parameter (JAX's ``param_shardings``):
    the largest divisible JAX axis over fsdp, replicated otherwise."""
    fsdp = axis_size(mesh, "fsdp")
    out = {}
    for name, p in model.named_parameters():
        jshape, _ = jax_layout(name, p.shape)
        out[name] = _placement(name, p.shape, "fsdp", _fsdp_axis(jshape, fsdp))
    return out


_REPLICATED_PARTS = ("time_ada", "time_ada_final", "time_embed", "final_block", "adaln")


def tp_role(name: str) -> Optional[str]:
    """The Megatron role of a DiT weight: ``'col'`` (q/k/v, the MLP's
    input projection: output split), ``'row'`` (the attention's and the
    MLP's output projections: input split) or None."""
    parts = name.split(".")
    if parts[-1] != "weight" or len(parts) < 3:
        return None
    if parts[-2] in ("to_q", "to_k", "to_v"):
        return "col"
    if parts[-2] == "proj" and parts[-3] in ("attn", "cross_attn"):
        return "row"
    if name.endswith("mlp.net.0.proj.weight"):
        return "col"
    if name.endswith("mlp.net.2.weight"):
        return "row"
    return None


def dit_param_shardings(mesh, model: nn.Module) -> Dict[str, Placement]:
    """Placements for a (Mask)DiT with JAX's tp + fsdp rules
    (``_tp_spec_for_path``): the time-conditioning heads (``time_ada*``,
    ``time_embed``, ``final_block``) and every ``adaln`` replicated;
    Megatron tp on the attention and MLP weights where the split axis
    divides; the fsdp rule elsewhere."""
    tp, fsdp = axis_size(mesh, "tp"), axis_size(mesh, "fsdp")
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        jshape, _ = jax_layout(name, p.shape)
        if any(n in _REPLICATED_PARTS for n in parts):
            out[name] = REPLICATED
            continue
        role = tp_role(name) if tp > 1 and len(jshape) == 2 else None
        if role == "col" and jshape[1] % tp == 0:
            out[name] = _placement(name, p.shape, "tp", 1)
        elif role == "row" and jshape[0] % tp == 0:
            out[name] = _placement(name, p.shape, "tp", 0)
        else:
            out[name] = _placement(name, p.shape, "fsdp", _fsdp_axis(jshape, fsdp))
    return out

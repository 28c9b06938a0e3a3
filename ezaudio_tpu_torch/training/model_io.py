"""Model bundles: the weights with the constructor's arguments
(counterpart of ``ezaudio_tpu/training/model_io.py``; reference
``audiotools/ml/layers/base.py``'s weights-with-metadata mode).

A bundle is a folder of two files, as the JAX package writes them:
``metadata.json`` (``kind``, the builder's ``kwargs``, free ``metadata``)
and ``params.npz``.  The port writes its state dict there under its own
parameter names and marks the bundle ``"format": "torch"``; a bundle the
JAX package wrote holds the flax tree flattened with ``/`` and loads
through the weight map (``convert/from_jax.py``), so it computes what the
JAX model computed.  Builders: ``maskdit`` (kwargs ``model=``, a model
config block), ``audio_vae`` (``AudioVAE``'s arguments, ``use_weight_norm``
among them: live ``weight_g``/``weight_v``) and ``dac`` (``DAC``'s).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

_BUILDERS: Dict[str, Callable[..., nn.Module]] = {}
FORMAT = "torch"


def register_model(name: str):
    """Register a module factory so bundles can be rebuilt by name."""

    def deco(fn):
        _BUILDERS[name] = fn
        return fn

    return deco


def _audio_vae(**kw) -> nn.Module:
    from ezaudio_tpu_torch.codecs.oobleck import AudioVAE

    kw.pop("dtype", None)
    return AudioVAE(**kw)


def _dac(**kw) -> nn.Module:
    from ezaudio_tpu_torch.codecs.dac import DAC

    kw.pop("dtype", None)
    for key in ("encoder_rates", "decoder_rates"):  # JSON keeps tuples as lists
        if key in kw:
            kw[key] = tuple(kw[key])
    return DAC(**kw)


def _register_builtins() -> None:
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config

    _BUILDERS.setdefault("maskdit", lambda **kw: maskdit_from_config(kw["model"]))
    _BUILDERS.setdefault("audio_vae", _audio_vae)
    _BUILDERS.setdefault("dac", _dac)


def _from_jax(kind: str, kwargs: dict, tree: dict) -> Dict[str, torch.Tensor]:
    from ezaudio_tpu_torch.convert.from_jax import (dac_state_dict_from_jax,
                                                    maskdit_state_dict_from_jax,
                                                    vae_state_dict_from_jax)

    tree = tree.get("params", tree)
    if kind == "maskdit":
        return maskdit_state_dict_from_jax(tree, kwargs["model"])
    if kind == "audio_vae":
        return vae_state_dict_from_jax(tree)
    if kind == "dac":
        return dac_state_dict_from_jax(tree)
    raise NotImplementedError(f"no weight map for a JAX bundle of kind {kind!r}")


def save_model(folder: str, kind: str, kwargs: dict, model: nn.Module,
               extra_metadata: Optional[dict] = None) -> str:
    """Write ``<folder>/{metadata.json, params.npz}`` (the state dict, f32)."""
    os.makedirs(folder, exist_ok=True)
    flat = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    np.savez(os.path.join(folder, "params.npz"), **flat)
    with open(os.path.join(folder, "metadata.json"), "w") as f:
        json.dump({"kind": kind, "kwargs": kwargs, "metadata": extra_metadata or {},
                   "format": FORMAT}, f, indent=2)
    return folder


def load_model(folder: str, device=None) -> Tuple[nn.Module, dict]:
    """Rebuild ``(module, metadata)`` from a bundle folder, the port's or
    the JAX package's; ``device`` defaults to the CPU."""
    from ezaudio_tpu_torch.convert.checkpoints import load_state_dict_strict

    _register_builtins()
    with open(os.path.join(folder, "metadata.json")) as f:
        meta = json.load(f)
    with torch.device(device or "cpu"):
        module = _BUILDERS[meta["kind"]](**dict(meta["kwargs"]))
    with np.load(os.path.join(folder, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    if meta.get("format") == FORMAT:
        sd = {k: torch.from_numpy(v) for k, v in flat.items()}
    else:
        tree: Dict[str, Any] = {}
        for key, value in flat.items():
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
        sd = _from_jax(meta["kind"], meta["kwargs"], tree)
    load_state_dict_strict(module, sd, folder)
    return module, meta["metadata"]

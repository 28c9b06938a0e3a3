"""Read the published EzAudio checkpoints from local files (counterpart of
``load_torch_checkpoint`` and ``strip_prefix`` in
``ezaudio_tpu/convert/torch_to_jax.py``, of ``_load_t5_state_dict`` in
``ezaudio_tpu/api/ezaudio.py`` and of the DAC CLI's ``.pth`` read in
``ezaudio_tpu/codecs/dacfile.py``).

The port keeps the reference torch names, so a state dict read here loads
into its module by name: the DiT and the ControlNet from key ``model``,
the VAE from key ``state_dict`` with its ``autoencoder.`` prefix stripped
and its weight norm folded (``from_jax.fold_weight_norm``), T5 through
``text/t5.py::t5_state_dict_from_hf``, a descript DAC ``.pth``
(``{"state_dict": ...}`` or bare) with its weight norm folded or live as
the model is built (:func:`load_dac`).  Everything is read on the host;
:func:`load_state_dict_strict` copies it into a module's own tensors,
wherever they live.  No download: every path is a local file.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn


def load_torch_checkpoint(path: str, key: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A torch ``.pt`` file's state dict, on the host; ``key`` picks an
    entry of the saved dict (``'model'``, ``'state_dict'``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if key is not None:
        if key not in obj:
            raise KeyError(f"{path}: no {key!r} entry (it has {sorted(obj)})")
        obj = obj[key]
    return dict(obj)


def strip_prefix(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` under ``prefix``, with the prefix removed."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_t5_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """T5 weights in HF names from a raw state-dict ``.pt``, an HF checkout
    directory (``model.safetensors``, then ``pytorch_model.bin``) or a
    ``.safetensors`` file.  ``safetensors`` is imported for that format
    only; without it the read raises an ImportError naming the file."""
    if os.path.isdir(path):
        for cand in ("model.safetensors", "pytorch_model.bin"):
            p = os.path.join(path, cand)
            if os.path.exists(p):
                path = p
                break
        else:
            raise FileNotFoundError(f"no T5 weights found under {path}")
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"reading {path} needs the safetensors package; "
                              "save the weights as a torch .pt state dict instead") from e
        return load_file(path, device="cpu")
    return load_torch_checkpoint(path)


def load_state_dict_strict(module: nn.Module, sd: Dict[str, torch.Tensor], path: str) -> None:
    """``module.load_state_dict(sd, strict=True)``: each tensor copied into
    the module's own, on its device and in its dtype.  A missing or
    unexpected key, or another shape, raises torch's error, which names
    them, prefixed with ``path``."""
    try:
        module.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise RuntimeError(f"{path}: {e}") from e


def load_dac(model: nn.Module, path: str) -> nn.Module:
    """A reference DAC ``.pth`` into ``model`` (``codecs/dac.py::DAC``),
    strictly: its ``state_dict`` entry or the whole file, ``weight_g`` and
    ``weight_v`` kept for a model built with ``use_weight_norm=True``,
    folded into ``weight`` otherwise."""
    from ezaudio_tpu_torch.convert.from_jax import fold_weight_norm

    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = dict(obj.get("state_dict", obj))
    if not getattr(model, "use_weight_norm", False):
        sd = fold_weight_norm(sd)
    load_state_dict_strict(model, sd, path)
    return model

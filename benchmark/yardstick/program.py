"""The system under test, built from a configuration file and the
benchmark's weights: the PyTorch port's ``EzAudio``.  The port is
imported here, inside the functions, and nowhere else."""

from __future__ import annotations

import torch

from yardstick.weights import load_into

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODEL_KEYS = ("model", "autoencoder", "text_encoder", "diff")


def _blocks(config: dict) -> dict:
    return {k: config[k] for k in MODEL_KEYS}


def build_ezaudio(config: dict, weights: dict, dtype: str, device):
    """``EzAudio`` at the configuration's widths with ``weights``, cast to
    ``dtype`` as ``EzAudio(dtype=...)`` casts (after the weights are in)."""
    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.text.t5 import T5EncoderConfig

    ez = EzAudio(config=_blocks(config), t5_config=T5EncoderConfig(**config["t5"]),
                 vae_config=config["vae"], dtype=torch.float32, device=device)
    load_into(ez.dit, weights["dit"])
    load_into(ez.t5, weights["t5"])
    load_into(ez.autoencoder.model, weights["vae"])
    ez._cast_(DTYPES[dtype])
    return ez


def recipe_kwargs(recipe: dict) -> dict:
    """``generate_audio``'s keywords for a traffic file's recipe."""
    kw = dict(ddim_steps=recipe["steps"], guidance_scale=recipe["guidance_scale"],
              guidance_rescale=recipe["guidance_rescale"], sampler=recipe["sampler"])
    if recipe["sampler"] == "ddim":
        kw["eta"] = recipe["eta"]
    return kw


def kernel_launches() -> dict:
    """The two kernels' launch counters, by dtype name."""
    from ezaudio_tpu_torch.ops.kernels.attention import fused_attention
    from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit

    return {"attention": {str(k).replace("torch.", ""): v
                          for k, v in fused_attention.launches_by_dtype.items()},
            "resunit": {str(k).replace("torch.", ""): v
                        for k, v in fused_residual_unit.launches_by_dtype.items()}}

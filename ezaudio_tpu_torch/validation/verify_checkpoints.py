"""Checkpoint verification for the published torch checkpoints, once they
are available locally (counterpart of ``scripts/verify_checkpoints.py``).

Per checkpoint:
  * every reference tensor loads (the port keeps the reference names, so the
    load is ``convert/checkpoints.py``'s strict ``load_state_dict``: a
    missing, extra or misshapen tensor raises, naming it) and the element
    counts of the file and the loaded model are reported;
  * VAE: an encode -> decode round trip of a sine, SI-SDR > 5 dB (the folded
    weight norm is right);
  * DiT (in bf16, as the JAX script's): the forward at t = 999 and t = 9
    differ (AdaLN conditioning live) and is finite;
  * the parameter counts, for a look against the reference.

The per-checkpoint checks are functions (``verify_vae``, ``verify_dit``,
``verify_controlnet``) returning the JAX script's report dicts, so tests
drive them on synthetic reference-format ``.pt`` files.  Their inputs are
drawn through ``utils.randn`` (ROADMAP F1).

    python -m ezaudio_tpu_torch.validation.verify_checkpoints --dit ezaudio_s3_l.pt \
        --vae 1m.pt [--controlnet energy_l.pt] [--model s3_l] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ezaudio_tpu_torch import utils
from ezaudio_tpu_torch.utils import resolve_device


def count_params(sd: Dict[str, torch.Tensor]) -> int:
    """Elements of a state dict's tensors."""
    return sum(int(np.prod(tuple(t.shape))) for t in sd.values())


def _count_reference(sd: Dict[str, torch.Tensor]) -> int:
    """Element count of a reference state dict without the deterministic
    buffers JAX regenerates in-graph (rotary ``inv_freq``, sinusoidal ``.pe``
    tables)."""
    return count_params({k: v for k, v in sd.items()
                         if "rotary.inv_freq" not in k and not k.endswith(".pe")})


def verify_vae(vae_path: str, vae_cfg: dict, sine_seconds: float = 2.0, device=None) -> dict:
    """Load a published-format VAE checkpoint (``{'state_dict':
    {'autoencoder.*', ... weight_g/weight_v}}``) with its weight norm
    folded, and run the encode -> decode sine round trip.  Returns the JAX
    script's report dict."""
    from ezaudio_tpu_torch.audio.metrics import si_sdr
    from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
    from ezaudio_tpu_torch.codecs.oobleck import vae_from_config
    from ezaudio_tpu_torch.convert.checkpoints import (load_state_dict_strict,
                                                       load_torch_checkpoint, strip_prefix)
    from ezaudio_tpu_torch.convert.from_jax import fold_weight_norm

    dev = resolve_device(device)
    sd = strip_prefix(load_torch_checkpoint(vae_path, "state_dict"), "autoencoder.")
    model = vae_from_config(vae_cfg)
    load_state_dict_strict(model, fold_weight_norm(sd), vae_path)
    model = model.to(dev).eval().requires_grad_(False)
    facade = AutoencoderFacade(model)

    sr = int(vae_cfg.get("sample_rate", 24000))
    t = np.arange(int(sine_seconds * sr)) / sr
    f0 = min(440.0, sr / 8)
    wav = (0.5 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    with torch.inference_mode():
        rec = facade.decode(facade.encode(wav[None, :, None], sample=False))[0, :, 0]
        rec = rec.float().cpu()
    n = min(len(rec), len(wav))
    sdr = float(si_sdr(rec[None, :n], torch.from_numpy(wav[None, :n])))
    return {
        "converted_params": count_params(model.state_dict()),
        "reference_tensors": count_params(sd),
        "roundtrip_si_sdr_db": sdr,
        "roundtrip_ok": sdr > 5,
        "finite": bool(torch.isfinite(rec).all()),
    }


def verify_dit(dit_path: str, model_cfg: dict, context_len: int = 100, device=None) -> dict:
    """Load a published-format DiT checkpoint (``{'model': state_dict}``),
    cast it to bf16 (after loading, as ``EzAudio(dtype=)`` does) and check
    conditioning liveness and finiteness on seeded inputs.  Returns the JAX
    script's report dict."""
    from ezaudio_tpu_torch.convert.checkpoints import (load_state_dict_strict,
                                                       load_torch_checkpoint)
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config

    dev = resolve_device(device)
    sd = load_torch_checkpoint(dit_path, "model")
    dit = maskdit_from_config(dict(model_cfg))
    load_state_dict_strict(dit, sd, dit_path)
    dit = utils.cast_params_(dit.to(dev), torch.bfloat16).eval().requires_grad_(False)
    n_src, n_conv = _count_reference(sd), _count_reference(dit.state_dict())

    L, C, D = model_cfg["img_size"], model_cfg["out_chans"], model_cfg["context_dim"]
    # one seed for both draws, as the JAX script's one key
    x = utils.randn((2, L, C), torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    ctx = utils.randn((2, context_len, D), torch.Generator(device=dev).manual_seed(0), dev,
                      torch.bfloat16)
    with torch.inference_mode():
        o_hi = dit(x, torch.full((2,), 999, device=dev), ctx)[0].float()
        o_lo = dit(x, torch.full((2,), 9, device=dev), ctx)[0].float()
    d = float((o_hi - o_lo).abs().mean())
    return {
        "converted_params": n_conv,
        "reference_tensors": n_src,
        "count_ok": n_conv == n_src,
        "t_conditioning_delta": d,
        # a freshly random-initialised reference model is nearly
        # time-invariant (zero-init AdaLN heads); trained weights are not
        "t_conditioning_live": d > 1e-3,
        "finite": bool(torch.isfinite(o_hi).all()),
    }


def verify_controlnet(cn_path: str, model_cfg: dict, cn_cfg: dict) -> dict:
    """Load a published-format ControlNet checkpoint (``{'model':
    state_dict}``) on the host.  Returns the JAX script's report dict."""
    from ezaudio_tpu_torch.convert.checkpoints import (load_state_dict_strict,
                                                       load_torch_checkpoint)
    from ezaudio_tpu_torch.models.controlnet import controlnet_from_config

    sd = load_torch_checkpoint(cn_path, "model")
    cn = controlnet_from_config(dict(model_cfg), dict(cn_cfg))
    load_state_dict_strict(cn, sd, cn_path)
    n_src, n_conv = _count_reference(sd), _count_reference(cn.state_dict())
    return {"converted_params": n_conv, "reference_tensors": n_src,
            "count_ok": n_conv == n_src}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m ezaudio_tpu_torch.validation.verify_checkpoints")
    p.add_argument("--dit", default=None)
    p.add_argument("--vae", default=None)
    p.add_argument("--controlnet", default=None)
    p.add_argument("--model", default="s3_l")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None, *, config: Optional[dict] = None, vae_config: Optional[dict] = None) -> dict:
    """Verify the files named; ``config`` (a model config with ``model:``
    and ``controlnet:`` blocks) replaces ``--model``'s, ``vae_config``
    ``vae.json``.  Returns ``{"vae"|"dit"|"controlnet": report}``."""
    from ezaudio_tpu_torch.config import ConfigDict, get_model_config
    from ezaudio_tpu_torch.validation.quality_validate import precision_line
    from ezaudio_tpu_torch.validation.quality_validate_mid import vae_json

    a = parse_args(argv)
    device = resolve_device(a.device)
    print(precision_line(device) + " (the DiT's check in bf16)", flush=True)
    cfg = ConfigDict.wrap(config) if config is not None else get_model_config(a.model)
    reports = {}
    if a.vae:
        r = reports["vae"] = verify_vae(a.vae, vae_config or vae_json(), device=device)
        print(f"VAE params: converted={r['converted_params']:,} (reference tensors total "
              f"{r['reference_tensors']:,} incl. unfolded v/g)")
        print(f"VAE round-trip SI-SDR on sine: {r['roundtrip_si_sdr_db']:.2f} dB "
              f"({'OK' if r['roundtrip_ok'] else 'SUSPICIOUS'})")
    if a.dit:
        r = reports["dit"] = verify_dit(a.dit, cfg.model.to_dict(), device=device)
        print(f"DiT params: converted={r['converted_params']:,} "
              f"reference={r['reference_tensors']:,} ({'OK' if r['count_ok'] else 'MISMATCH'})")
        print(f"DiT t-conditioning delta |f(999)-f(9)|: {r['t_conditioning_delta']:.4f} "
              f"({'OK' if r['t_conditioning_live'] else 'SUSPICIOUS'}); finite={r['finite']}")
    if a.controlnet:
        r = reports["controlnet"] = verify_controlnet(a.controlnet, cfg.model.to_dict(),
                                                      cfg.controlnet.to_dict())
        print(f"ControlNet params: converted={r['converted_params']:,} "
              f"reference={r['reference_tensors']:,} ({'OK' if r['count_ok'] else 'MISMATCH'})")
    return reports


if __name__ == "__main__":
    main()

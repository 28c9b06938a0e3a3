"""The demo CLIs on the port (counterparts of the root ``t2a_demo.py`` and
``controlnet_demo.py``, which drive the JAX package):

    python -m ezaudio_tpu_torch.demo t2a --prompt "a dog barking" --out out.wav \\
        [--model s3_l] [--ckpt ... --vae ... --t5 ...] [--steps 100] [--length 10] [--fast]
    python -m ezaudio_tpu_torch.demo controlnet --prompt "dog barking" --ref ref.wav \\
        --out out.wav [--model energy] [--controlnet ...] [--steps 50]

The same arguments as those scripts, plus ``--device`` (CUDA unless another
is named).  Without checkpoints the models run on seeded random weights.
``--fast`` is the t2a script's fast recipe: DPM-Solver++ at 25 steps (at
most ``--steps``), ``layer_cache=(2, 2)``, chunked bf16 attention, int8
linears and ``cfg_refresh=2``.  The clip is written with ``save_wav``.
"""

from __future__ import annotations

import argparse
from typing import Optional


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m ezaudio_tpu_torch.demo")
    sub = p.add_subparsers(dest="demo", required=True)

    t2a = sub.add_parser("t2a", help="text to audio")
    t2a.add_argument("--prompt", default="a dog barking in the distance")
    t2a.add_argument("--out", default="output.wav")
    t2a.add_argument("--model", default="s3_l")
    t2a.add_argument("--ckpt", default=None)
    t2a.add_argument("--vae", default=None)
    t2a.add_argument("--t5", default=None)
    t2a.add_argument("--tokenizer", default=None)
    t2a.add_argument("--length", type=float, default=10)
    t2a.add_argument("--steps", type=int, default=100)
    t2a.add_argument("--guidance-scale", type=float, default=5.0)
    t2a.add_argument("--guidance-rescale", type=float, default=0.75)
    t2a.add_argument("--seed", type=int, default=0)
    t2a.add_argument("--bf16", action="store_true")
    t2a.add_argument("--fast", action="store_true",
                     help="DPM-Solver++-25 + layer_cache(2,2) + chunked-bf16 attention + "
                          "int8 linears + cfg_refresh(2)")
    t2a.add_argument("--device", default=None, help="torch device (default: CUDA)")

    cn = sub.add_parser("controlnet", help="energy-conditioned ControlNet")
    cn.add_argument("--prompt", default="a dog barking")
    cn.add_argument("--ref", required=True, help="reference wav for energy")
    cn.add_argument("--out", default="output.wav")
    cn.add_argument("--model", default="energy")
    cn.add_argument("--ckpt", default=None)
    cn.add_argument("--controlnet", default=None)
    cn.add_argument("--vae", default=None)
    cn.add_argument("--tokenizer", default=None)
    cn.add_argument("--steps", type=int, default=50)
    cn.add_argument("--guidance-scale", type=float, default=3.5)
    cn.add_argument("--conditioning-scale", type=float, default=1.0)
    cn.add_argument("--surpass-noise", type=float, default=0.0)
    cn.add_argument("--seed", type=int, default=0)
    cn.add_argument("--bf16", action="store_true")
    cn.add_argument("--device", default=None, help="torch device (default: CUDA)")
    return p.parse_args(argv)


def fast_recipe(steps: int) -> dict:
    """``--fast``: the t2a script's fast recipe, its steps at most ``steps``."""
    return dict(sampler="dpm", ddim_steps=min(25, steps), layer_cache=(2, 2),
                attn_impl="chunked_bf16", quant="int8", cfg_refresh=2)


def main(argv=None, *, config: Optional[dict] = None, t5_config=None,
         vae_config: Optional[dict] = None) -> str:
    """Run a demo; returns the path written.  ``config`` / ``t5_config`` /
    ``vae_config`` replace the model's configs (tiny models in tests)."""
    import torch

    from ezaudio_tpu_torch.data.audio_io import save_wav

    args = parse_args(argv)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.demo == "t2a":
        from ezaudio_tpu_torch.api.ezaudio import EzAudio

        ez = EzAudio(model_name=args.model, config=config, ckpt_path=args.ckpt,
                     vae_path=args.vae, t5_path=args.t5, tokenizer_path=args.tokenizer,
                     t5_config=t5_config, vae_config=vae_config, dtype=dtype,
                     device=args.device)
        recipe = {"ddim_steps": args.steps}
        if args.fast:
            recipe.update(fast_recipe(args.steps))
        sr, wav = ez.generate_audio(args.prompt, length=args.length,
                                    guidance_scale=args.guidance_scale,
                                    guidance_rescale=args.guidance_rescale,
                                    random_seed=args.seed, **recipe)
    else:
        from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet

        ez = EzAudioControlNet(model_name=args.model, config=config, ckpt_path=args.ckpt,
                               controlnet_path=args.controlnet, vae_path=args.vae,
                               tokenizer_path=args.tokenizer, t5_config=t5_config,
                               vae_config=vae_config, dtype=dtype, device=args.device)
        sr, wav = ez.generate_audio(args.prompt, args.ref, surpass_noise=args.surpass_noise,
                                    ddim_steps=args.steps,
                                    guidance_scale=args.guidance_scale,
                                    conditioning_scale=args.conditioning_scale,
                                    random_seed=args.seed)
    save_wav(args.out, wav, sr)
    print(f"wrote {args.out} ({wav.shape[-1] / sr:.1f}s @ {sr} Hz)")
    return args.out


if __name__ == "__main__":
    main()

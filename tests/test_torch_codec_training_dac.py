"""The codec trainer's ``'dac'`` step on the CPU against the JAX package's
``make_codec_train_steps`` (a tiny DAC with live weight norm and quantizer
dropout, the dropout counts injected on both sides), by the limits of
``tests/test_torch_codec_training.py``; and the trainer's own draws."""

import numpy as np
import pytest
import torch

from ezaudio_tpu.codecs.dac import DAC as JaxDAC
from ezaudio_tpu_torch.codecs.dac import DAC
from ezaudio_tpu_torch.codecs.discriminator import Discriminator
from ezaudio_tpu_torch.codecs.oobleck import AudioVAE
from ezaudio_tpu_torch.convert.from_jax import dac_state_dict_from_jax
from ezaudio_tpu_torch.training import codec_trainer as tct
from tests.test_torch_codec_training import (DISC, STEP, VAE, _audio, _check,  # noqa: F401
                                             _one_thread, _run)

DAC_KW = dict(encoder_dim=4, encoder_rates=(2, 4), latent_dim=8, decoder_dim=16,
              decoder_rates=(4, 2), n_codebooks=2, codebook_size=16, codebook_dim=4,
              sample_rate=8000, quantizer_dropout=0.5, use_weight_norm=True)


def test_dac_step_matches_jax():
    got, want = _run("dac", JaxDAC, DAC, DAC_KW, dac_state_dict_from_jax, _audio(1),
                     dict(dropout=np.array([1, 2])), seed=13)
    assert {"gen/commitment", "gen/codebook"} <= set(got[torch.float32][1])
    _check(got, want)


def test_step_draws_come_from_seed_and_step():
    """Without ``draws``, step n draws from (seed, n): two trainers on the
    same weights and seed agree, another seed differs."""
    def run(seed):
        gen = torch.Generator().manual_seed(0)
        vae, disc = tct.init_codec_train_state(AudioVAE(**VAE), Discriminator(**DISC), gen)
        step = tct.make_codec_train_steps(vae, disc, "vae", **STEP)
        return [step(torch.from_numpy(_audio(0)), seed)["gen/loss"].item() for _ in range(2)]

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    gen = torch.Generator().manual_seed(0)
    vae, disc = tct.init_codec_train_state(AudioVAE(**VAE), Discriminator(**DISC), gen)
    assert all(p.abs().max() > 0 for p in list(vae.parameters()) + list(disc.parameters()))
    with pytest.raises(ValueError, match="'vae' or 'dac'"):
        tct.make_codec_train_steps(vae, disc, "encodec")

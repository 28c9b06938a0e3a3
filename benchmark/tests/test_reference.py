"""The plain reference at a tiny size: it agrees with itself from the
same seed, is told apart from a perturbed output, and matches the port on
the CPU."""

import torch

from yardstick import drivers, reference as ref, weights as W


def _clips(tiny, seed, prec="f32"):
    pipe = W.reference_pipeline(tiny, W.make_weights(tiny, seed, "cpu"), "cpu", prec)
    recipe = dict(sampler="ddim", steps=4, guidance_scale=5.0, guidance_rescale=0.75, eta=1.0)
    return drivers.reference_clips(pipe, ["a dog barks", "rain"], 3, 2, slice(None), 20,
                                   recipe, "cpu", prec)


def test_same_seed_same_clips(tiny):
    a, b = _clips(tiny, 11), _clips(tiny, 11)
    assert torch.equal(a, b)
    assert drivers.rel_err(a, b) == 0.0


def test_other_weights_and_perturbations_are_told_apart(tiny):
    a = _clips(tiny, 11)
    assert drivers.rel_err(_clips(tiny, 12), a) > 0.1
    assert drivers.rel_err(a * 1.01, a) > 5e-3
    assert drivers.rel_err(_clips(tiny, 11, "fp8"), a) > 1e-2


def test_weights_are_seeded_on_the_device(tiny):
    w1, w2 = W.make_weights(tiny, 5, "cpu"), W.make_weights(tiny, 5, "cpu")
    for comp in w1:
        assert all(torch.equal(w1[comp][n], w2[comp][n]) for n in w1[comp])
    w3 = W.make_weights(tiny, 6, "cpu")
    assert not torch.equal(w1["dit"]["mask_embed"], w3["dit"]["mask_embed"])
    assert torch.all(w1["dit"]["model.final_block.norm.weight"] == 1)


def test_schedule():
    s = ref.Schedule(dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
                          beta_start=0.00085, beta_end=0.012, prediction_type="v_prediction",
                          rescale_betas_zero_snr=True, timestep_spacing="trailing",
                          clip_sample=False))
    assert s.abar[-1] == 0.0 and list(s.timesteps(4)) == [999, 749, 499, 249]

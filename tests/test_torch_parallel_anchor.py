"""The direct anchor of the port's sharded training to the JAX package:
JAX's train step on ``make_mesh(fsdp=2, tp=2)`` (its parameters placed by
its ``dit_param_shardings``, the batch by its ``shard_batch``) against the
port's ``Trainer.create(..., mesh=make_mesh(fsdp=2, tp=2))`` step in a
spawned gloo world of 4 (``tests/torch_worlds.py``), from the same
weights, batch and draws; in f32, and in bf16 mixed precision (JAX's
MaskDiT built with ``dtype=jnp.bfloat16``, f32 parameters) by the
statistical rule of ``tests/test_torch_train_bf16.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ezaudio_tpu_torch.parallel.dryrun import MODEL
from tests import torch_worlds
from tests.test_torch_bf16 import assert_bf16_close
from tests.torch_worlds import spawn_world

ANCHOR_B = 8
ANCHOR_OPT = dict(learning_rate=1e-3, warmup=0, grad_clip=0.5, weight_decay=0.01,
                  snr_gamma=5.0)
# the bf16 anchor's MaskDiT: the dry run's at depth 2 without remat (XLA
# compiles the depth-4 remat bf16 step on the mesh in ~28 s, this in ~17 s;
# the sharded bf16 step under remat is held to the single-process one in
# tests/test_torch_parallel.py)
BF16_MODEL = dict(MODEL, depth=2, use_checkpoint=False)


@pytest.fixture(scope="module")
def anchor():
    """The JAX side of the fsdp 2 x tp 2 anchor: the dry run's MaskDiT
    with weights drawn by shape from a seed (every leaf non-zero), a batch
    of 8 with a padded text mask, and numpy draws (noise, timesteps, CFG
    drops, span masks) that replace ``jax.random`` in JAX's step and go
    to the port's ``draws=``.  ``port`` holds numpy alone (the ranks import
    no JAX)."""
    from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit
    from tests.test_torch_controlnet import _seeded_init

    L, C, Lc, D = MODEL["img_size"], MODEL["out_chans"], 5, MODEL["context_dim"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _seeded_init(np.random.default_rng(21)))
        model = jax_maskdit(MODEL)
        params = model.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                            jnp.zeros((1, L, C)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, Lc, D)))["params"]
    rng = np.random.default_rng(22)
    B = ANCHOR_B
    mask = np.arange(Lc)[None] < np.array([5, 5, 3, 5, 2, 5, 4, 5])[:, None]
    batch = dict(latents=rng.standard_normal((B, L, C)).astype(np.float32),
                 text=rng.standard_normal((B, Lc, D)).astype(np.float32), text_mask=mask,
                 uncond=rng.standard_normal((1, Lc, D)).astype(np.float32),
                 uncond_mask=np.arange(Lc)[None] < 2)
    draws = dict(noise=rng.standard_normal((B, L, C)).astype(np.float32),
                 t=np.array([17, 999, 500, 3, 250, 750, 120, 880], np.int32),
                 cfg=np.array([0.05, 0.6, 0.3, 0.08, 0.9, 0.5, 0.2, 0.7], np.float32),
                 ratio=rng.uniform(0.25, 1.0, B).astype(np.float32),
                 span_round=rng.uniform(size=B).astype(np.float32),
                 span_scores=rng.uniform(size=(B, L - MODEL["mask_span"])).astype(np.float32),
                 select=np.array([0.1, 0.9] * 4, np.float32))
    # the bf16 step: the same MaskDiT at BF16_MODEL's depth (its first
    # in- and out-blocks, the mid block), the batch and the noise rounded
    # to bf16 (the port rounds its f32 noise draw to the latents' dtype)
    params16 = dict(params, model={k: v for k, v in params["model"].items()
                                   if k not in ("in_blocks_1", "out_blocks_1")})
    bf16 = dict(model=BF16_MODEL, weights=_weights(params16, BF16_MODEL),
                batch={k: (_round_bf16(v) if v.dtype == np.float32 else v)
                       for k, v in batch.items()},
                draws=dict(draws, noise=_round_bf16(draws["noise"])), opt=ANCHOR_OPT)
    return dict(model=model, params=params, params16=params16,
                port=dict(model=MODEL, weights=_weights(params, MODEL), batch=batch,
                          draws=draws, opt=ANCHOR_OPT, bf16=bf16))


def _weights(params, cfg):
    from ezaudio_tpu_torch.convert.from_jax import maskdit_state_dict_from_jax

    return {k: v.numpy() for k, v in
            maskdit_state_dict_from_jax(jax.device_get(params), cfg).items()}


def _round_bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def world(anchor):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return spawn_world(torch_worlds.anchor_rank, dict(anchor=anchor["port"]), deadline=180.0)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_step(anchor):
    """JAX's f32 step (``_jax_sharded_step``)."""
    port = anchor["port"]
    return _jax_sharded_step(anchor["params"], port["model"], anchor["model"], port["batch"],
                             port["draws"])


@pytest.fixture(scope="module")
def jax_step_bf16(anchor):
    """JAX's bf16 trainer's step: the MaskDiT built with
    ``dtype=jnp.bfloat16`` (f32 parameters), the batch in bf16, the noise
    rounded to bf16."""
    from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit

    a = anchor["port"]["bf16"]
    batch = {k: (jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32 else v)
             for k, v in a["batch"].items()}
    return _jax_sharded_step(anchor["params16"], a["model"],
                             jax_maskdit(a["model"], dtype=jnp.bfloat16), batch, a["draws"])


def _jax_sharded_step(params, cfg, model, batch, d):
    """JAX's train step (AdamW, clip 0.5, weight decay 0.01, snr_gamma 5)
    of ``model`` on ``make_mesh(fsdp=2, tp=2)`` over 4 of the 8 virtual
    devices, its parameters placed by its ``dit_param_shardings`` and the
    batch by its ``shard_batch``, the draws ``d`` replaced while it traces:
    the loss, the global norm, the gradients (kept by a transformation
    wrapped round the optimizer: one compiled step) and the updated
    parameters, under the port's names."""
    import optax

    from ezaudio_tpu.diffusion.ddim import DDIMSchedule as JaxSchedule
    from ezaudio_tpu.parallel.mesh import dit_param_shardings as jax_dit
    from ezaudio_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ezaudio_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from ezaudio_tpu.training.optim import make_optimizer as jax_make_optimizer
    from ezaudio_tpu.training.trainer import TrainState, make_train_step
    from ezaudio_tpu_torch.parallel.dryrun import DIFF
    from tests.test_torch_training import jax_draws

    opt = dict(ANCHOR_OPT)
    snr_gamma = opt.pop("snr_gamma")
    inner = jax_make_optimizer(params, **opt)
    tx = optax.GradientTransformation(
        lambda p: (jax.tree.map(jnp.zeros_like, p), inner.init(p)),
        lambda g, s, p=None: (lambda u: (u[0], (g, u[1])))(inner.update(g, s[1], p)))
    mesh = jax_make_mesh(fsdp=2, tp=2, devices=jax.devices()[:4])
    state = TrainState.create(jax.tree.map(jax.device_put, jax.tree.map(jnp.array, params),
                                           jax_dit(mesh, params)), tx)
    step = make_train_step(model, JaxSchedule.from_config(DIFF), tx, snr_gamma=snr_gamma,
                           mesh=mesh)
    batch = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    with jax_draws([d["cfg"], d["ratio"], d["span_round"], d["span_scores"], d["select"]],
                   normal=d["noise"], randint=d["t"]):
        state, m = step(state, batch, jax.random.PRNGKey(0))

    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                grads=_weights(state.opt_state[0], cfg), params=_weights(state.params, cfg))


def test_loss_and_global_norm_equal_jax(world, jax_step):
    """rtol 1e-5, the single-process anchor's limit
    (``tests/test_torch_training.py``): one f32 reduction in another order."""
    np.testing.assert_allclose(world["loss"], jax_step["loss"], rtol=1e-5)
    np.testing.assert_allclose(world["grad_norm"], jax_step["grad_norm"], rtol=1e-5)
    assert jax_step["grad_norm"] > ANCHOR_OPT["grad_clip"]  # the clip fires


def test_gradients_equal_jax(world, jax_step):
    """Each gradient within 1e-4 of its tensor's largest entry (the
    single-process anchor's limit: the backward sums over the batch, the
    tokens, the heads and now the shards in another order than XLA).  The
    bias of a cross-attention's key norm has a gradient of 0 in exact
    arithmetic (it shifts every score of a row alike, which the softmax
    ignores): its rounding noise is held, on both sides, within 1e-6 of
    the step's largest gradient (``chip_smoke.ZERO_GRAD_TOL``'s rule)."""
    from ezaudio_tpu_torch.parallel.dryrun import MODEL

    got, want = world["grads"], jax_step["grads"]
    assert set(got) == {k for k in want if not k.endswith("inv_freq")}
    largest = max(float(np.abs(w).max()) for w in want.values())
    zeros = [n for n in got if n.endswith("cross_attn.norm_k.bias")]
    assert len(zeros) == MODEL["depth"] + 1
    for n, g in got.items():
        w = want[n]
        if n in zeros:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * largest, n
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                       err_msg=n)


def test_updated_parameters_equal_jax(world, jax_step, anchor):
    """Every parameter within 2 lr (Adam's first step moves it by
    lr * g / (|g| + eps), whose sign flips for a gradient near 0 with any
    rounding) and within 1e-3 lr where the clipped gradient exceeds 1e-4
    (the single-process anchor's limits); the step moved them."""
    lr = ANCHOR_OPT["learning_rate"]
    clip = min(1.0, ANCHOR_OPT["grad_clip"] / jax_step["grad_norm"])
    for n, p in world["params"].items():
        diff = np.abs(p - jax_step["params"][n])
        assert diff.max() <= 2 * lr, n
        if n in jax_step["grads"]:
            big = clip * np.abs(jax_step["grads"][n]) > 1e-4
            assert diff[big].max(initial=0) <= 1e-3 * lr, n
    moved = max(float(np.abs(world["params"][n] - anchor["port"]["weights"][n]).max())
                for n in world["grads"])
    assert moved > 0.5 * lr


def _flat(tree, names):
    return np.concatenate([np.asarray(tree[n], np.float32).ravel() for n in names])


def test_bf16_step_equals_jax_bf16(world, jax_step_bf16, anchor):
    """The port's bf16 step on fsdp 2 x tp 2 (FSDP2 gathering in bf16,
    ``mixed_precision`` casting the tp shards and the replicated weights)
    against JAX's bf16 step on its ``make_mesh(fsdp=2, tp=2)``, from the same
    weights, bf16 batch and draws, by ``tests/test_torch_train_bf16.py``'s
    rule: the gradients (one vector) and the first step's updates (one
    vector) no farther from JAX bf16's than twice JAX bf16's distance from
    the port's f32 step on the same rounded inputs (which holds JAX's f32
    step within 1e-4 of each gradient's scale, above), correlated above
    0.99; the loss, one scalar mean where XLA's fusions keep f32 inside
    while torch rounds every op, within 2^-8 of JAX bf16's, relative."""
    got, ref, want = world["bf16"], world["bf16_ref"], jax_step_bf16
    names = sorted(got["grads"])
    assert set(names) == {k for k in want["grads"] if not k.endswith("inv_freq")}
    assert_bf16_close(_flat(got["grads"], names), _flat(want["grads"], names),
                      _flat(ref["grads"], names), 0.99)
    start = anchor["port"]["bf16"]["weights"]
    upd = [{n: t["params"][n] - start[n] for n in names} for t in (got, want, ref)]
    assert_bf16_close(*(_flat(u, names) for u in upd), 0.99)
    assert abs(got["loss"] - want["loss"]) <= 2.0 ** -8 * abs(want["loss"])
    assert all(g.dtype == np.float32 for g in got["grads"].values())
    assert all(p.dtype == np.float32 for p in got["params"].values())

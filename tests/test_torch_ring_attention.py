"""The port's sequence-parallel ring (``ezaudio_tpu_torch/parallel/ring_attention.py``)
against the JAX package's ``ring_attention`` on its 8 virtual CPU devices.

Every case of ``tests/test_ring_attention.py`` has its counterpart: no
mask, key mask, dp x sp, a custom scale, bf16, an indivisible sequence,
the gradient, the ``Attention`` module, long-audio sampling, ``'ring'``
outside a context, the MaskDiT forward, and ``'auto'`` routing.  The cases
that need collectives run in one spawned gloo world of 4 processes
(``file://`` rendezvous under ``tmp_path``, joined under a deadline); the
others drive the ring's per-hop functions in this process over
hand-rotated blocks, in the order the ranks run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu.ops.attention import dot_product_attention
from ezaudio_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ezaudio_tpu.parallel.ring_attention import ring_attention as jax_ring
from ezaudio_tpu.parallel.ring_attention import ring_context as jax_ring_context
from ezaudio_tpu_torch.parallel.ring_attention import (hop_accumulate, ring_blocks_backward,
                                                       ring_blocks_forward, ring_finish,
                                                       ring_init)
from tests.torch_worlds import DIFF, DIM, HEADS, ring_rank, spawn_world


def _jmesh(dp=1, sp=4):
    return jax_make_mesh(dp=dp, sp=sp, devices=jax.devices()[: dp * sp])


def _qkv(seed, B=2, H=4, L=64, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(3)]


def _mask(seed, B, L):
    m = np.random.default_rng(seed).random((B, L)) < 0.7
    m[:, 0] = True
    return m


def _jax_ring(q, k, v, mesh, **kw):
    return np.asarray(jax.jit(lambda q, k, v: jax_ring(q, k, v, mesh, **kw))(q, k, v),
                      np.float32)


# ---------------------------------------------------------------------------
# the weights carried from JAX
# ---------------------------------------------------------------------------

def _attention_params():
    from ezaudio_tpu.models.blocks import Attention
    from tests.test_torch_modules import seeded_params

    x = jnp.zeros((1, 8, DIM))
    return seeded_params(Attention(dim=DIM, num_heads=HEADS, rope_mode="shared"),
                         np.random.default_rng(9), x)


def _attention_sd(params):
    from ezaudio_tpu_torch.convert.from_jax import _attention, _inv_freq

    sd = {}
    _attention(sd, "a", params["params"])
    sd = {k[2:]: v for k, v in sd.items()}
    sd["rotary.inv_freq"] = _inv_freq(DIM // HEADS)
    return sd


def _tiny_model_cfg():
    from tests.tiny_config import TINY_CONFIG

    return dict(TINY_CONFIG["model"])


def _maskdit_params():
    from ezaudio_tpu.models.maskdit import maskdit_from_config
    from tests.test_torch_modules import seeded_params

    cfg = _tiny_model_cfg()
    m = maskdit_from_config(cfg)
    return m, seeded_params(m, np.random.default_rng(10), jnp.zeros((1, cfg["img_size"],
                                                                      cfg["out_chans"])),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, cfg["context_dim"])))


def _maskdit_sd(params):
    from ezaudio_tpu_torch.convert.from_jax import maskdit_state_dict_from_jax

    return maskdit_state_dict_from_jax(params["params"], _tiny_model_cfg())


@pytest.fixture(scope="module")
def inputs():
    attn_params = _attention_params()
    jm, mparams = _maskdit_params()
    cfg = _tiny_model_cfg()
    rng = np.random.default_rng(11)
    B, L, C, Dc = 2, cfg["img_size"], cfg["out_chans"], cfg["context_dim"]
    data = dict(
        qkv=_qkv(0), qkv48=_qkv(1, L=48), mask48=_mask(2, 2, 48), qkv_dp=_qkv(3, B=4, L=32),
        qkv32=_qkv(4, L=32), mask32=_mask(5, 2, 32),
        attn_sd={k: v.numpy() for k, v in _attention_sd(attn_params).items()},
        x_attn=rng.standard_normal((4, 32, DIM)).astype(np.float32),
        cfg=cfg, maskdit_sd={k: v.numpy() for k, v in _maskdit_sd(mparams).items()},
        maskdit_in=(rng.standard_normal((B, L, C)).astype(np.float32),
                    np.full((B,), 321, np.int64),
                    rng.standard_normal((B, 8, Dc)).astype(np.float32)),
        long_ctx=rng.standard_normal((2, 6, Dc)).astype(np.float32),
        long_noise=rng.standard_normal((2, 4 * L, C)).astype(np.float32))
    return data, attn_params, jm, mparams


@pytest.fixture(scope="module")
def world(inputs):
    return spawn_world(ring_rank, inputs[0])


# ---------------------------------------------------------------------------
# TestRingExactness
# ---------------------------------------------------------------------------

def test_matches_jax_no_mask(world, inputs):
    q, k, v = inputs[0]["qkv"]
    want = _jax_ring(q, k, v, _jmesh(1, 8))
    np.testing.assert_allclose(world["no_mask"], want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(want, np.asarray(dot_product_attention(q, k, v)), atol=1e-5)


def test_matches_jax_with_key_mask(world, inputs):
    d = inputs[0]
    q, k, v = d["qkv48"]
    want = np.asarray(jax.jit(lambda q, k, v, m: jax_ring(q, k, v, _jmesh(1, 4), key_mask=m))(
        q, k, v, d["mask48"]))
    np.testing.assert_allclose(world["key_mask"], want, atol=1e-5, rtol=1e-5)


def test_dp_times_sp_mesh(world, inputs):
    q, k, v = inputs[0]["qkv_dp"]
    want = _jax_ring(q, k, v, _jmesh(2, 4), batch_axes=("dp",))
    np.testing.assert_allclose(world["dp_sp"], want, atol=1e-5, rtol=1e-5)


def test_custom_scale(world, inputs):
    q, k, v = inputs[0]["qkv32"]
    want = _jax_ring(q, k, v, _jmesh(1, 4), scale=0.25)
    np.testing.assert_allclose(world["scale"], want, atol=1e-5, rtol=1e-5)


def test_bf16_inputs(world, inputs):
    q, k, v = (jnp.asarray(t, jnp.bfloat16) for t in inputs[0]["qkv32"])
    want = np.asarray(jax.jit(lambda q, k, v: jax_ring(q, k, v, _jmesh(1, 4)))(q, k, v),
                      np.float32)
    assert world["bf16_dtype"] == "torch.bfloat16"
    np.testing.assert_allclose(world["bf16"], want, atol=2e-2, rtol=2e-2)


def test_indivisible_sequence_raises(world, inputs):
    q, k, v = (t[:, :, :36] for t in inputs[0]["qkv"])
    with pytest.raises(AssertionError):
        jax_ring(q, k, v, _jmesh(1, 8))
    assert world["indivisible"].startswith("AssertionError: sequence 34/34")


# ---------------------------------------------------------------------------
# TestRingGradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["grad", "grad_mask"])
def test_grad_matches_jax(world, inputs, case):
    d = inputs[0]
    q, k, v = d["qkv32"]
    mask = None if case == "grad" else d["mask32"]
    mesh = _jmesh(1, 4)
    want = jax.jit(jax.grad(lambda q, k, v: (jax_ring(q, k, v, mesh, key_mask=mask) ** 2).sum(),
                            argnums=(0, 1, 2)))(q, k, v)
    for got, w in zip(world[case], want):
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# TestModuleRingImpl and TestAutoRouting
# ---------------------------------------------------------------------------

def _jax_attention(inputs, impl, mesh=None):
    from ezaudio_tpu.models.blocks import Attention

    x = jnp.asarray(inputs[0]["x_attn"])
    att = Attention(dim=DIM, num_heads=HEADS, rope_mode="shared", attention_impl=impl)
    if mesh is None:
        return np.asarray(att.apply(inputs[1], x))
    with jax_ring_context(mesh, batch_axes=("dp",)):
        return np.asarray(jax.jit(lambda p, x: att.apply(p, x))(inputs[1], x))


def test_attention_module_ring_equals_jax(world, inputs):
    want = _jax_attention(inputs, "ring", _jmesh(2, 4))
    np.testing.assert_allclose(world["module"], want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(want, _jax_attention(inputs, "einsum"), atol=1e-5)


def test_long_audio_sampling_ring_equals_jax(world, inputs):
    """Latents 4x longer than the trained img_size, the sequence split over
    sp=2 and the batch over dp=2: the port's ring sampler equals JAX's
    unsharded einsum sampler (RoPE length extension, eta 0)."""
    from ezaudio_tpu.diffusion.ddim import DDIMSchedule as JDDIM
    from ezaudio_tpu.diffusion.sampling import sample_latents as jsample

    d, _, jm, params = inputs
    ctx = jnp.asarray(d["long_ctx"])

    def model_fn(lat, t):
        c = jnp.concatenate([ctx] * (lat.shape[0] // 2), axis=0)
        return jm.apply(params, lat, t, c)[0]

    want = np.asarray(jax.jit(lambda n: jsample(model_fn, JDDIM.from_config(DIFF), n,
                                                jax.random.PRNGKey(13), 2,
                                                guidance_scale=3.0, eta=0.0))(
        jnp.asarray(d["long_noise"])))
    assert world["long"].shape == want.shape == (2, 4 * d["cfg"]["img_size"], 8)
    np.testing.assert_allclose(world["long"], want, atol=2e-5, rtol=2e-5)


def test_ring_without_context_raises():
    from ezaudio_tpu.models.blocks import Attention as JAttention
    from ezaudio_tpu_torch.models.blocks import Attention

    with pytest.raises(AssertionError):
        JAttention(dim=16, num_heads=2, attention_impl="ring").init(jax.random.PRNGKey(0),
                                                                    jnp.zeros((1, 8, 16)))
    with pytest.raises(RuntimeError, match="ring_context"):
        Attention(16, 2, attention_impl="ring")(torch.zeros(1, 8, 16))


def test_maskdit_forward_ring_equals_jax(world, inputs):
    d, _, jm, params = inputs
    x, t, c = (jnp.asarray(a) for a in d["maskdit_in"])
    want = np.asarray(jm.apply(params, x, t.astype(jnp.int32), c)[0])
    np.testing.assert_allclose(world["maskdit"], want, atol=2e-5, rtol=2e-5)


def test_auto_routes_to_ring_inside_context(world, inputs):
    """'auto' inside a ring_context whose mesh has sp > 1 runs the ring
    (one ring call per self-attention) and equals JAX's auto routing there."""
    assert world["auto_calls"] == 1
    np.testing.assert_allclose(world["auto"], _jax_attention(inputs, "auto", _jmesh(2, 4)),
                               atol=1e-5, rtol=1e-5)


def test_auto_stays_on_the_kernel_when_sp_is_one(world, inputs):
    assert world["auto_sp1_calls"] == 0
    np.testing.assert_allclose(world["auto_sp1"], _jax_attention(inputs, "einsum"), atol=1e-5)


# ---------------------------------------------------------------------------
# the per-hop functions in one process (what the chip phase drives)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["no_mask", "key_mask", "scale"])
def test_hand_rotated_blocks_match_jax(inputs, case):
    d = inputs[0]
    q, k, v = d["qkv32"]
    kw, tkw = {}, {}
    if case == "key_mask":
        kw["key_mask"], tkw["key_mask"] = d["mask32"], torch.from_numpy(d["mask32"])
    if case == "scale":
        kw["scale"] = tkw["scale"] = 0.25
    want = _jax_ring(q, k, v, _jmesh(1, 4), **kw)
    got, _, _ = ring_blocks_forward(*map(torch.from_numpy, (q, k, v)), sp=4, **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_hand_rotated_blocks_bf16_and_kernel_twin(inputs):
    """bf16 blocks against JAX's bf16 ring; f32 blocks against kernel 1's
    plain twin (the function the chip phase holds them to)."""
    from ezaudio_tpu_torch.ops.kernels.attention import attention_plain

    q, k, v = inputs[0]["qkv32"]
    jq = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)]
    want = np.asarray(jax.jit(lambda a, b, c: jax_ring(a, b, c, _jmesh(1, 4)))(*jq), np.float32)
    tq = [torch.from_numpy(t) for t in (q, k, v)]
    got, _, _ = ring_blocks_forward(*(t.bfloat16() for t in tq), sp=4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)
    mask = torch.from_numpy(inputs[0]["mask32"])
    f32, _, _ = ring_blocks_forward(*tq, key_mask=mask, sp=4)
    np.testing.assert_allclose(f32.numpy(), attention_plain(*tq, key_mask=mask).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_hand_rotated_backward_matches_jax_grad(inputs, masked):
    d = inputs[0]
    q, k, v = d["qkv32"]
    mask = d["mask32"] if masked else None
    mesh = _jmesh(1, 4)
    want = jax.jit(jax.grad(lambda q, k, v: (jax_ring(q, k, v, mesh, key_mask=mask) ** 2).sum(),
                            argnums=(0, 1, 2)))(q, k, v)
    tq = [torch.from_numpy(t) for t in (q, k, v)]
    out, _, _ = ring_blocks_forward(*tq, key_mask=None if mask is None
                                    else torch.from_numpy(mask), sp=4)
    got = ring_blocks_backward(*tq, 2 * out, key_mask=None if mask is None
                               else torch.from_numpy(mask), sp=4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_one_hop_is_the_online_softmax(inputs):
    """A single hop over the whole sequence, finished, is plain attention;
    its log-sum-exp is the logits' logsumexp."""
    q, k, v = (torch.from_numpy(t) for t in inputs[0]["qkv32"])
    mask = torch.ones(2, 32, dtype=torch.bool)
    m, l, acc = hop_accumulate(q, k, v, mask, 0.25, *ring_init(q))
    out, lse = ring_finish(m, l, acc)
    s = (q @ k.transpose(-1, -2)) * 0.25
    np.testing.assert_allclose(out.numpy(), (torch.softmax(s, -1) @ v).numpy(), atol=1e-5)
    np.testing.assert_allclose(lse[..., 0].numpy(), torch.logsumexp(s, -1).numpy(), atol=1e-5)

"""The port's mesh, sharding rules and sharded paths
(``ezaudio_tpu_torch/parallel/{mesh,sharding}.py``) against the JAX package
and against the port's own single-process runs.

In this process: ``make_mesh``'s assertions against JAX's, ``shard_batch``'s
rows, and each parameter's placement from ``dit_param_shardings`` against
the JAX spec of the same tiny MaskDiT (the JAX side drawn by shape alone).
In one spawned gloo world of 4 (``tests/torch_worlds.py``): the rows on a
real mesh; dp2 x fsdp2 and dp1 x fsdp2 x tp2 train steps with AdamW and
Adafactor (clip on) against the single-process step (which
``tests/test_torch_training.py`` holds to JAX; the sharded step is held to
JAX's sharded step directly in ``tests/test_torch_parallel_anchor.py``);
the checkpoints both
ways; ``EzAudio(mesh=)``, the ControlNet and a ``GenerationServer`` drain
against single-device runs; ``train_cli --mesh-fsdp 2`` against the
single-process CLI, each rank encoding only its rows.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ezaudio_tpu_torch.parallel.mesh import (AXES, Placement, activation_sharding,
                                             constrain_batch, dit_param_shardings, jax_layout,
                                             mesh_shape, param_shardings, shard_batch)
from tests import torch_worlds
from tests.torch_worlds import spawn_world


class StubMesh:
    """The sizes and this rank's coordinates of a mesh, without a process
    group: what the placement rules and ``shard_batch`` read."""

    def __init__(self, coords=None, **sizes):
        self.sizes = [sizes.get(a, 1) for a in AXES]
        self.coords = coords or {}

    def size(self, i=None):
        return int(np.prod(self.sizes)) if i is None else self.sizes[i]

    def get_local_rank(self, axis):
        return self.coords.get(axis, 0)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,dp,fsdp,tp,sp", [(8, None, 2, 2, 1), (8, None, 1, 1, 8),
                                             (4, 1, 2, 2, 1), (8, None, 3, 1, 1),
                                             (8, 2, 2, 1, 1), (1, None, 2, 1, 1)])
def test_make_mesh_assertions_match_jax(n, dp, fsdp, tp, sp):
    from ezaudio_tpu.parallel.mesh import make_mesh as jax_make_mesh

    try:
        want = tuple(jax_make_mesh(dp=dp, fsdp=fsdp, tp=tp, sp=sp,
                                   devices=jax.devices()[:n]).shape.values())
    except AssertionError:
        with pytest.raises(AssertionError):
            mesh_shape(n, dp, fsdp, tp, sp)
        return
    assert mesh_shape(n, dp, fsdp, tp, sp) == want


def test_shard_batch_rows_and_its_value_error():
    x = np.arange(24).reshape(8, 3)
    for d in range(2):
        for f in range(2):
            mesh = StubMesh({"dp": d, "fsdp": f}, dp=2, fsdp=2, tp=2)
            r = 2 * d + f
            got = shard_batch(mesh, {"x": x, "t": torch.from_numpy(x), "u": x[:1], "s": "a"})
            np.testing.assert_array_equal(got["x"], x[2 * r: 2 * r + 2])
            assert torch.equal(got["t"], torch.from_numpy(x[2 * r: 2 * r + 2]))
            np.testing.assert_array_equal(got["u"], x[:1])
            assert got["s"] == "a"
    with pytest.raises(ValueError, match="not divisible by the dp world size 4"):
        shard_batch(StubMesh(dp=2, fsdp=2), x[:6])
    np.testing.assert_array_equal(shard_batch(StubMesh(dp=2, fsdp=2), x[:6], strict=False),
                                  x[:6])


def test_activation_sharding_is_batch_only_and_the_pin_is_the_identity():
    x = torch.ones(2, 3)
    with activation_sharding(StubMesh(dp=2, fsdp=2)):
        assert constrain_batch(x) is x
    with pytest.raises(AssertionError, match="batch-only"):
        activation_sharding(StubMesh(dp=2, sp=2))


def test_jax_layout_maps_each_jax_axis_to_its_torch_dim():
    assert jax_layout("a.to_q.weight", (32, 16)) == ((16, 32), [1, 0])
    assert jax_layout("f.final_layer.weight", (8, 4, 3)) == ((3, 4, 8), [2, 1, 0])
    assert jax_layout("c.weight", (8, 4, 3, 5)) == ((3, 5, 4, 8), [2, 3, 1, 0])
    assert jax_layout("model.patch_embed.proj.weight", (64, 17, 1)) == ((17, 64), [1, 0])
    assert jax_layout("n.weight", (64,)) == ((64,), [0])
    assert jax_layout("b.scale_shift_table", (6, 64)) == ((6, 64), [0, 1])


# ---------------------------------------------------------------------------
# placements against JAX's dit_param_shardings
# ---------------------------------------------------------------------------

def _port_names_to_jax_specs(mesh, cfg, fn):
    """Port parameter name -> JAX spec of the leaf it is converted from:
    every JAX leaf filled with its index, carried through
    ``maskdit_state_dict_from_jax``."""
    from ezaudio_tpu.models.maskdit import maskdit_from_config as jax_maskdit
    from ezaudio_tpu_torch.convert.from_jax import maskdit_state_dict_from_jax

    m = jax_maskdit(cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: m.init({"params": key, "mask": key},
                                           jnp.zeros((1, cfg["img_size"], cfg["out_chans"])),
                                           jnp.zeros((1,), jnp.int32),
                                           jnp.zeros((1, 1, cfg["context_dim"])))["params"])
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    ids = jax.tree_util.tree_unflatten(tree, [np.full(s.shape, i, np.float32)
                                              for i, s in enumerate(leaves)])
    specs = jax.tree_util.tree_leaves(fn(mesh, shapes),
                                      is_leaf=lambda x: hasattr(x, "spec"))
    sd = maskdit_state_dict_from_jax(ids, cfg)
    out = {}
    for name, t in sd.items():
        if t.numel() and t.dtype == torch.float32 and (t == t.flatten()[0]).all():
            i = int(t.flatten()[0])
            spec = tuple(specs[i].spec)
            out[name] = spec + (None,) * (len(leaves[i].shape) - len(spec))
    return out


def _padded(pl: Placement, name, shape):
    n = len(jax_layout(name, shape)[0])
    return pl.spec + (None,) * (n - len(pl.spec))


@pytest.mark.parametrize("dp,fsdp,tp", [(2, 2, 2), (1, 4, 2), (2, 4, 1)])
def test_dit_placements_equal_jax(dp, fsdp, tp):
    from ezaudio_tpu.parallel.mesh import dit_param_shardings as jax_dit
    from ezaudio_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from tests.tiny_config import TINY_CONFIG

    cfg = dict(TINY_CONFIG["model"])
    want = _port_names_to_jax_specs(jax_make_mesh(dp=dp, fsdp=fsdp, tp=tp,
                                                  devices=jax.devices()[: dp * fsdp * tp]),
                                    cfg, jax_dit)
    model = maskdit_from_config(cfg)
    got = dit_param_shardings(StubMesh(dp=dp, fsdp=fsdp, tp=tp), model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(got) == set(shapes) and set(want) <= set(got)
    compared = 0
    for name, spec in want.items():
        assert _padded(got[name], name, shapes[name]) == spec, name
        compared += 1
    assert compared >= 0.9 * len(got)
    axes = {pl.axis for pl in got.values()}
    assert "fsdp" in axes and (("tp" in axes) == (tp > 1))
    for name, pl in got.items():  # the torch dim is the JAX axis' own
        if pl.axis is not None:
            jshape, dims = jax_layout(name, shapes[name])
            assert dims[pl.spec.index(pl.axis)] == pl.dim


def test_fsdp_placements_equal_jax():
    from ezaudio_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ezaudio_tpu.parallel.mesh import param_shardings as jax_fsdp
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from tests.tiny_config import TINY_CONFIG

    cfg = dict(TINY_CONFIG["model"])
    want = _port_names_to_jax_specs(jax_make_mesh(dp=2, fsdp=4, devices=jax.devices()[:8]),
                                    cfg, jax_fsdp)
    model = maskdit_from_config(cfg)
    got = param_shardings(StubMesh(dp=2, fsdp=4), model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for name, spec in want.items():
        assert _padded(got[name], name, shapes[name]) == spec, name


# ---------------------------------------------------------------------------
# the spawned world
# ---------------------------------------------------------------------------

def _cli_workspace(root):
    """Eight 1.5-2.5 s clips, a manifest and the dry run's tiny EzAudio
    config with ``opt:`` (batch 4) and ``data:`` blocks."""
    from ezaudio_tpu_torch.data.audio_io import save_wav
    from ezaudio_tpu_torch.parallel.dryrun import API_CONFIG, SR

    audio = root / "audio"
    audio.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        n = int((1.5 + 0.125 * i) * SR)
        save_wav(str(audio / f"{i}.wav"), (0.3 * rng.standard_normal(n)).astype(np.float32),
                 SR)
        rows.append(dict(audio_path=f"{i}.wav", caption=f"sound number {i}", split="train",
                         audio_length=n / SR, absolute_index=i, fine_tune_data=True))
    with open(root / "meta.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    cfg = json.loads(json.dumps(API_CONFIG))
    cfg["model"]["depth"] = 2
    cfg["opt"] = dict(learning_rate=1e-3, warmup=1, grad_clip=1.0, batch_size=4)
    cfg["data"] = dict(train=dict(data_dir=str(audio) + "/", meta_dir=str(root / "meta.csv"),
                                  subset="train", seg_length=1, sr=SR, mono=True))
    path = str(root / "tiny.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Single-device checkpoints and a CLI workspace made here, then one
    world of 4 running every sharded case; the single-process CLI run."""
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.parallel.dryrun import VAE_CONFIG, _t5
    from ezaudio_tpu_torch.training import train_cli
    from ezaudio_tpu_torch.training.trainer import Trainer

    root = tmp_path_factory.mktemp("parallel")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ckpt_a = {}
        for opt in ("adamw", "adafactor"):
            tr = Trainer.create(torch_worlds.tiny_dit(), DDIMSchedule.from_config(
                torch_worlds.DIFF), torch_worlds.opt_cfg(opt))
            tr.train_step(torch_worlds.train_batch(), 3)
            tr.save_checkpoint(str(root / "ckpt_a" / opt))
            ckpt_a[opt] = torch.load(str(root / "ckpt_a" / opt / "1" / "state.pt"),
                                     weights_only=True)
        data = dict(ckpt_a=str(root / "ckpt_a"), ckpt_b=str(root / "ckpt_b"),
                    cli_config=_cli_workspace(root), cli_save=str(root / "cli_mesh"),
                    cli_log=str(root / "cli_log"))
        out = spawn_world(torch_worlds.parallel_rank, data, deadline=300.0)
        single = {}
        train_cli.main(["--config-name", data["cli_config"], "--max-steps", "2",
                        "--save-every-step", "100", "--save-dir", str(root / "cli_single"),
                        "--log-dir", data["cli_log"], "--device", "cpu"],
                       t5_config=_t5(), vae_config=VAE_CONFIG,
                       on_step=lambda s, m: single.__setitem__(s, float(m["loss"])))
    finally:
        torch.set_num_threads(n)
    return out, ckpt_a, single, data


def test_rows_on_a_real_mesh(world):
    np.testing.assert_array_equal(world[0]["rows"]["rank0_rows"], [[0, 1, 2], [3, 4, 5]])


@pytest.mark.parametrize("case", ["dp2xfsdp2/adamw", "dp2xfsdp2/adafactor",
                                  "fsdp2xtp2/adamw", "fsdp2xtp2/adafactor"])
def test_sharded_train_step_equals_single_process(world, case):
    """Two steps (clip 0.5, lr 1e-3): the loss, the clip's global norm and
    every gradient within 1e-5 (relative) of the single-process step's;
    the parameters within 1e-5 of a single-process optimizer fed the
    sharded run's gradients (at step 1 an Adam-family update is ~lr * sign
    of the gradient, which turns rounding in near-zero gradients into
    lr-sized steps: the gradients are compared before the update)."""
    e = world[0][f"train/{case}"]
    assert e["moved"] > 1e-4  # the step did move the parameters
    assert e["loss"] < 1e-5 and e["norm"] < 1e-5, e
    assert e["grad"] < 1e-5, e
    assert e["param"] < 1e-5, e


def test_int8_under_tp_quantizes_from_the_whole_weight(world):
    """int8 products in every linear of the tiny MaskDiT at fsdp 2 x tp 2:
    a row split's int8 weight is the whole layer's, sliced (its scales
    the whole rows'), and the forward equals the unsharded int8 forward
    to the rounding of the row splits' partial sums (1e-5 of its scale)."""
    e = world[0]["int8_tp"]
    assert e["row_split_weight_equal"]
    assert e["rel_err"] < 1e-5, e


def test_a_wrapped_model_is_freed_by_the_collector(world):
    """A trainer's model is freed with its last reference, plain and on a
    mesh without FSDP2; wrapped in FSDP2 its hooks keep it in a reference
    cycle until the garbage collector runs (ROADMAP F20), and it is freed
    then.  (The first trainer of a process is held by a cycle of torch's
    lazy imports: "warm" takes that.)"""
    freed = world[0]["freed"]
    assert freed["plain"] == (False, False) and freed["dp4"] == (False, False), freed
    assert freed["fsdp2"] == (True, False), freed


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoints_keep_the_single_device_layout_both_ways(world, opt):
    """A single-device checkpoint restores into an fsdp2 x tp2 trainer bit
    for bit (model and optimizer); the sharded trainer's checkpoint after a
    step restores on one process, bit for bit, and trains on."""
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.training.trainer import Trainer

    out, ckpt_a = world[0]["checkpoint"][opt], world[1][opt]
    _same(ckpt_a["model"], out["model"], "model")
    _same(ckpt_a["optimizer"], out["optimizer"], "optimizer")
    assert out["step"] == 1
    tr = Trainer.create(torch_worlds.tiny_dit(), DDIMSchedule.from_config(torch_worlds.DIFF),
                        torch_worlds.opt_cfg(opt))
    tr.restore_checkpoint(os.path.join(world[3]["ckpt_b"], opt))
    assert tr.step == 2
    _same({k: v for k, v in tr.model.state_dict().items()}, out["after"], "after")
    assert np.isfinite(float(tr.train_step(torch_worlds.train_batch(), 3)["loss"]))


@pytest.mark.parametrize("mesh", ["dp4", "dp2xfsdp2", "fsdp2xtp2"])
@pytest.mark.parametrize("path", ["staged", "fused", "edit"])
def test_ezaudio_mesh_equals_solo(world, mesh, path):
    """Three prompts (padded to the world of 4), DDIM with eta noise
    (staged), DPM through the fused program, and an edit: every rank's
    waveform equals the single-device one within 1e-5."""
    assert world[0]["api"][0][f"{mesh}/{path}"] < 1e-5


def test_controlnet_on_a_sharded_base_equals_solo(world):
    assert world[0]["api"][0]["controlnet/fsdp2xtp2"] < 1e-5


def test_server_drain_on_a_mesh_equals_solo(world):
    errs, buckets = world[0]["api"]
    assert all(b % 4 == 0 for b in buckets), buckets
    assert errs["server/dp4"] < 1e-5


def test_train_cli_mesh_fsdp_2_equals_single_process(world):
    """``train_cli --mesh-fsdp 2`` in a world of 4 (dp 2 x fsdp 2): its
    losses are the single-process CLI's within 1e-5."""
    got, want = world[0]["train_cli"]["losses"], world[2]
    assert got.keys() == want.keys() == {1, 2}
    for s in want:
        assert abs(got[s] - want[s]) <= 1e-5 * abs(want[s]), (got, want)


def test_train_cli_encodes_and_embeds_only_its_rows(world):
    """Each rank runs the VAE encode and T5 on its own rows of the batch
    (4 rows over a data world of 4: one each), not on the whole batch;
    T5's first call is the empty prompt for CFG dropout."""
    rows = world[0]["train_cli"]["rows"]
    assert rows["encode"] == [1, 1], rows
    assert rows["t5"] == [1, 1, 1], rows

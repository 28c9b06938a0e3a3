"""Spawned gloo worlds for the port's parallel tests (imported by
``tests/test_torch_ring_attention.py``, ``tests/test_torch_parallel.py`` and
``tests/test_torch_parallel_anchor.py``).

The functions here run in the spawned ranks, which import this module and
nothing of JAX: each rank joins a ``file://`` rendezvous, runs its cases
on the port alone and sends rank 0's results back; the test modules hold
them against the JAX package.  :func:`spawn_world` joins every rank under
a deadline, so a hung collective fails the test.
"""

import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

WORLD = 4
DEADLINE = 240.0
DIM, HEADS = 64, 4
DIFF = dict(num_train_timesteps=1000, beta_schedule="scaled_linear", beta_start=0.00085,
            beta_end=0.012, prediction_type="v_prediction", rescale_betas_zero_snr=True,
            timestep_spacing="trailing", clip_sample=False)


def spawn_world(fn, data, world=WORLD, deadline=DEADLINE):
    """Run ``fn(rank, rendezvous, data, queue)`` on ``world`` spawned ranks;
    rank 0's result.  A rank that fails, dies or passes ``deadline`` fails
    the caller."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=fn, args=(r, path, data, q)) for r in range(world)]
        for p in procs:
            p.start()
        results, end = {}, time.time() + deadline
        try:
            while len(results) < world:
                if time.time() > end:
                    raise TimeoutError(f"{world - len(results)} ranks passed {deadline} s")
                try:
                    r, res = q.get(timeout=2.0)
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        raise RuntimeError(f"a rank died: {[p.exitcode for p in procs]}")
                    continue
                results[r] = res
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    for r, res in results.items():
        if isinstance(res, str) and res != "ok":
            raise AssertionError(f"rank {r} failed:\n{res}")
    return results[0]


# ---------------------------------------------------------------------------
# tests/test_torch_ring_attention.py
# ---------------------------------------------------------------------------

def _ring_cases(rank, data):
    """Every collective case on this rank; numpy results (rank 0's kept)."""
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.diffusion.sampling import sample_latents
    from ezaudio_tpu_torch.models.blocks import Attention
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.parallel import gather_rows, make_mesh, ring_attention, ring_context
    from ezaudio_tpu_torch.parallel import shard_batch

    ra = sys.modules["ezaudio_tpu_torch.parallel.ring_attention"]  # the package exports
    out = {}                                                   # a function of that name
    T = torch.from_numpy
    sp4 = make_mesh(dp=1, sp=4)
    dpsp = make_mesh(dp=2, sp=2)
    q, k, v = map(T, data["qkv"])
    out["no_mask"] = ring_attention(q, k, v, sp4).numpy()
    q48, k48, v48 = map(T, data["qkv48"])
    out["key_mask"] = ring_attention(q48, k48, v48, sp4, key_mask=T(data["mask48"])).numpy()
    qd, kd, vd = (shard_batch(dpsp, t) for t in map(T, data["qkv_dp"]))
    out["dp_sp"] = gather_rows(dpsp, ring_attention(qd, kd, vd, dpsp,
                                                    batch_axes=("dp",))).numpy()
    q32, k32, v32 = map(T, data["qkv32"])
    out["scale"] = ring_attention(q32, k32, v32, sp4, scale=0.25).numpy()
    bf = ring_attention(q32.bfloat16(), k32.bfloat16(), v32.bfloat16(), sp4)
    out["bf16_dtype"] = str(bf.dtype)
    out["bf16"] = bf.float().numpy()
    try:
        ring_attention(*(t[:, :, :34] for t in (q, k, v)), sp4)
        out["indivisible"] = "no error"
    except AssertionError as e:
        out["indivisible"] = f"AssertionError: {e}"
    for name, mask in (("grad", None), ("grad_mask", T(data["mask32"]))):
        g = [t.clone().requires_grad_(True) for t in (q32, k32, v32)]
        (ring_attention(*g, sp4, key_mask=mask) ** 2).sum().backward()
        out[name] = [t.grad.numpy() for t in g]

    # the module, and 'auto' routing (ring calls counted)
    att = Attention(DIM, HEADS, rope_mode="shared", attention_impl="ring")
    att.load_state_dict({k_: T(v_) for k_, v_ in data["attn_sd"].items()})
    auto = Attention(DIM, HEADS, rope_mode="shared")
    auto.load_state_dict(att.state_dict())
    x = T(data["x_attn"])
    calls = []
    real = ra.ring_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    ra.ring_attention = counted
    try:
        with torch.no_grad(), ring_context(dpsp, batch_axes=("dp",)):
            out["module"] = gather_rows(dpsp, att(shard_batch(dpsp, x))).numpy()
            n0 = len(calls)
            out["auto"] = gather_rows(dpsp, auto(shard_batch(dpsp, x))).numpy()
            out["auto_calls"] = len(calls) - n0
        dp4 = make_mesh(dp=4, sp=1)
        with torch.no_grad(), ring_context(dp4, batch_axes=("dp",)):
            n0 = len(calls)
            out["auto_sp1"] = gather_rows(dp4, auto(shard_batch(dp4, x))).numpy()
            out["auto_sp1_calls"] = len(calls) - n0
    finally:
        ra.ring_attention = real

    # MaskDiT forward, then long-audio sampling, self-attention on the ring
    cfg = data["cfg"]
    m = maskdit_from_config(dict(cfg, attention_impl="ring")).eval()
    m.load_state_dict({k_: T(v_) for k_, v_ in data["maskdit_sd"].items()})
    with torch.no_grad(), ring_context(dpsp, batch_axes=("dp",)):
        xm, tm, cm = (shard_batch(dpsp, T(a)) for a in data["maskdit_in"])
        y, _ = m(xm, tm, cm)
        out["maskdit"] = gather_rows(dpsp, y).numpy()
        ctx = shard_batch(dpsp, T(data["long_ctx"]))

        def model_fn(lat, t):
            c = torch.cat([ctx] * (lat.shape[0] // ctx.shape[0]), dim=0)
            o, _ = m(lat, torch.tensor(t), c)
            return o

        lat = sample_latents(model_fn, DDIMSchedule.from_config(DIFF),
                             shard_batch(dpsp, T(data["long_noise"])), 2, guidance_scale=3.0,
                             eta=0.0)
        out["long"] = gather_rows(dpsp, lat).numpy()
    return out


def _run_rank(cases, rank, path, data, q, world):
    """Join the gloo world, run ``cases(rank, data)``, send rank 0's result
    (the others send "ok" or their traceback), leave the world."""
    try:
        torch.set_num_threads(1)
        from ezaudio_tpu_torch.parallel import init_distributed

        init_distributed("cpu", init_method=f"file://{path}", rank=rank, world_size=world)
        out = cases(rank, data)
        q.put((rank, out if rank == 0 else "ok"))
    except Exception:
        q.put((rank, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def ring_rank(rank, path, data, q):
    _run_rank(_ring_cases, rank, path, data, q, WORLD)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def tiny_dit(**switches):
    """The dry run's tiny MaskDiT (remat on; ``switches`` over its
    config), seeded weights."""
    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.parallel.dryrun import MODEL

    m = maskdit_from_config(dict(MODEL, **switches))
    init_random_(m, torch.Generator().manual_seed(0))
    return m


def train_batch():
    rng = np.random.default_rng(0)
    B, L, C, Lc, D = 8, 32, 8, 5, 24

    def arr(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)

    return {"latents": arr(B, L, C), "text": arr(B, Lc, D),
            "text_mask": torch.arange(Lc)[None].expand(B, Lc) < torch.arange(2, 2 + B)[:, None],
            "uncond": arr(1, Lc, D), "uncond_mask": torch.ones(1, Lc, dtype=torch.bool)}


def opt_cfg(opt):
    return dict(learning_rate=1e-3, warmup=0, grad_clip=0.5, optimizer=opt)


def _rows_case(rank):
    from ezaudio_tpu_torch.parallel import gather_rows, make_mesh, shard_batch
    from ezaudio_tpu_torch.parallel.mesh import axis_size, data_rank, data_world

    mesh = make_mesh(dp=2, fsdp=2)
    assert data_world(mesh) == 4 and data_rank(mesh) == rank
    x = torch.arange(24).view(8, 3)
    got = shard_batch(mesh, {"a": x, "u": x[:1], "n": x.numpy(), "s": "text"})
    assert torch.equal(got["a"], x[2 * rank: 2 * rank + 2]) and torch.equal(got["u"], x[:1])
    assert (got["n"] == x.numpy()[2 * rank: 2 * rank + 2]).all() and got["s"] == "text"
    assert torch.equal(gather_rows(mesh, got["a"]), x)
    try:
        shard_batch(mesh, x[:6])
        raise AssertionError("no ValueError")
    except ValueError as e:
        assert "not divisible by the dp world size 4" in str(e)
    assert torch.equal(shard_batch(mesh, x[:6], strict=False), x[:6])
    tp_sp = make_mesh(tp=2, sp=2)
    assert data_world(tp_sp) == 1 and axis_size(tp_sp, "sp") == 2
    assert torch.equal(shard_batch(tp_sp, x), x)
    return {"rank0_rows": got["a"].numpy()}


def _train_case(mesh, opt):
    """A sharded trainer, the single-process trainer and a single-process
    optimizer fed the sharded run's gradients, two steps each: the
    relative errors of loss, norm and gradients, and the parameters'
    largest difference from the fed optimizer's."""
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.training.optim import make_optimizer
    from ezaudio_tpu_torch.training.trainer import Trainer

    sched = DDIMSchedule.from_config(DIFF)
    sh = Trainer.create(tiny_dit(), sched, opt_cfg(opt), mesh=mesh)
    ref = Trainer.create(tiny_dit(), sched, opt_cfg(opt))
    fed_model = tiny_dit()
    fed = make_optimizer(fed_model, **{k: v for k, v in opt_cfg(opt).items()})
    errs = dict(loss=0.0, norm=0.0, grad=0.0)
    for _ in range(2):
        a = sh.step_fn(train_batch(), 3, return_grads=True)
        b = ref.step_fn(train_batch(), 3, return_grads=True)
        full = {n: sh.sharding.to_full(n, g) for n, g in a["grads"].items()}
        scale = max(float(g.abs().max()) for g in b["grads"].values())
        errs["loss"] = max(errs["loss"], abs(float(a["loss"] - b["loss"])) / abs(float(b["loss"])))
        errs["norm"] = max(errs["norm"], abs(float(a["grad_norm"] - b["grad_norm"]))
                           / float(b["grad_norm"]))
        errs["grad"] = max(errs["grad"], max(float((full[n] - b["grads"][n]).abs().max())
                                             for n in full) / scale)
        fed.update(full)
    p_sh, p_fed = sh.sharding.full_state_dict(), fed_model.state_dict()
    errs["param"] = max(float((p_sh[n] - p_fed[n]).abs().max()) for n in p_fed)
    errs["moved"] = max(float((p_fed[n] - v).abs().max())
                        for n, v in tiny_dit().state_dict().items())
    return errs


def _bf16(batch):
    return {k: (v.bfloat16() if torch.is_tensor(v) and v.is_floating_point() else v)
            for k, v in batch.items()}


def _flat(grads):
    return torch.cat([grads[n].float().reshape(-1) for n in sorted(grads)]).numpy()


def _train_bf16_case(mesh, opt_kw):
    """The bf16 mixed-precision step on ``mesh``, the single-process bf16
    step and the single-process f32 step (the statistical rule's
    reference) from the same weights, bf16 batch and draws: the losses, the
    gradients and the updates as flat vectors (the sharded run's whole),
    the parameters' largest difference from a single-process optimizer fed
    the sharded run's gradients, and whether every master and gradient
    stayed f32."""
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.training.optim import make_optimizer
    from ezaudio_tpu_torch.training.trainer import Trainer

    sched, cfg, bf16 = DDIMSchedule.from_config(DIFF), dict(opt_cfg("adamw"), **opt_kw), \
        torch.bfloat16
    sh = Trainer.create(tiny_dit(), sched, cfg, dtype=bf16, mesh=mesh)
    one = Trainer.create(tiny_dit(), sched, cfg, dtype=bf16)
    ref = Trainer.create(tiny_dit(), sched, cfg)
    fed_model = tiny_dit()
    fed = make_optimizer(fed_model, **cfg)
    start = tiny_dit().state_dict()
    a = sh.step_fn(_bf16(train_batch()), 3, return_grads=True)
    b = one.step_fn(_bf16(train_batch()), 3, return_grads=True)
    c = ref.step_fn(train_batch(), 3, return_grads=True)
    full = {n: sh.sharding.to_full(n, g) for n, g in a["grads"].items()}
    fed.update(full)
    p_sh = sh.sharding.full_state_dict()
    upd = [{n: v - start[n] for n, v in sd.items() if n in full}
           for sd in (p_sh, one.model.state_dict(), ref.model.state_dict())]
    return {"loss": [float(a["loss"]), float(b["loss"]), float(c["loss"])],
            "grads": [_flat(full), _flat(b["grads"]), _flat(c["grads"])],
            "update": [_flat(u) for u in upd],
            "fed_param": max(float((p_sh[n] - v).abs().max())
                             for n, v in fed_model.state_dict().items()),
            "f32": (all(g.dtype == torch.float32 for g in full.values())
                    and all(p.dtype == torch.float32 for p in sh.model.parameters()))}


VARIANT = dict(act_layer="gesnake", pe_method="abs")  # f32-kept parameters FSDP2 shards


def _bf16_wrapped_case(data):
    """A MaskDiT whose snakes and absolute positional embedding FSDP2
    shards (``VARIANT``) on dp 2 x fsdp 2 in bf16: the dtype of each weight
    its layers read in the forward (norms, snakes, the embedding, the
    linears), the FSDP2 groups, the masters' and gradients' dtypes, the
    loss against the single-process bf16 step, and a checkpoint written
    and read back into a fresh sharded trainer (model and optimizer)."""
    from torch.distributed.fsdp import FSDPModule

    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.ops.embeddings import PEWrapper
    from ezaudio_tpu_torch.ops.mlp import ActProj
    from ezaudio_tpu_torch.ops.norms import LayerNorm
    from ezaudio_tpu_torch.ops.quant import QuantLinear
    from ezaudio_tpu_torch.parallel import make_mesh
    from ezaudio_tpu_torch.training.trainer import Trainer
    from ezaudio_tpu_torch.utils import cast_names

    mesh, sched, bf16 = make_mesh(dp=2, fsdp=2), DDIMSchedule.from_config(DIFF), torch.bfloat16

    def create(sharded):
        return Trainer.create(tiny_dit(**VARIANT), sched, opt_cfg("adamw"), dtype=bf16,
                              mesh=mesh if sharded else None)

    def read_dtypes(model, seen):
        kinds = {LayerNorm: ("weight", "bias"), ActProj: ("alpha", "beta"),
                 PEWrapper: ("abs_pe",), QuantLinear: ("weight",)}
        hooks = []
        for name, m in model.named_modules():
            for kind, attrs in kinds.items():
                if isinstance(m, kind) and getattr(m, attrs[0], None) is not None:
                    hooks.append(m.register_forward_pre_hook(
                        lambda mod, _, n=name, a=attrs: seen.update(
                            {f"{n}.{x}": str(getattr(mod, x).dtype) for x in a})))
        return hooks

    out = {}
    for key, sharded in (("one", False), ("mesh", True)):
        tr, seen = create(sharded), {}
        hooks = read_dtypes(tr.model, seen)
        m = tr.step_fn(_bf16(train_batch()), 3, return_grads=True)
        for h in hooks:
            h.remove()
        out[key] = {"loss": float(m["loss"]), "read": seen}
    out["groups"] = sum(isinstance(m, FSDPModule) for m in tr.model.modules())
    out["sharded_f32"] = sorted(tr.sharding.fsdp_names - cast_names(tr.model, bf16))
    out["masters_f32"] = all(p.dtype == torch.float32 for p in tr.model.parameters())
    out["grads_f32"] = all(g.dtype == torch.float32 for g in m["grads"].values())
    tr.save_checkpoint(data["ckpt_bf16"])
    back = create(True).restore_checkpoint(data["ckpt_bf16"])
    out["ckpt_model"] = all(torch.equal(a, b) for a, b in zip(
        tr.sharding.full_state_dict().values(), back.sharding.full_state_dict().values()))
    out["ckpt_opt"] = _numpy(tr.optimizer.state_dict()), _numpy(back.optimizer.state_dict())
    out["saved"] = {k: v.numpy().copy() for k, v in tr.sharding.full_state_dict().items()}
    return out


def _jax_anchor_case(a, dtype=None):
    """One fsdp 2 x tp 2 step from the model config, weights, batch and
    draws ``a`` that the JAX package's step on ``make_mesh(fsdp=2, tp=2)``
    takes in ``tests/test_torch_parallel_anchor.py`` (the batch in
    ``dtype``): the loss, the global norm, every gradient and every
    updated parameter, whole."""
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.parallel import make_mesh
    from ezaudio_tpu_torch.training.trainer import Trainer

    T = torch.from_numpy
    model = maskdit_from_config(a["model"])
    model.load_state_dict({k: T(v) for k, v in a["weights"].items()})
    tr = Trainer.create(model, DDIMSchedule.from_config(DIFF), a["opt"], dtype=dtype,
                        mesh=make_mesh(fsdp=2, tp=2))
    b = {k: T(v) for k, v in a["batch"].items()}
    m = tr.step_fn(b if dtype is None else _bf16(b), 0,
                   draws={k: T(v) for k, v in a["draws"].items()}, return_grads=True)
    sh = tr.sharding
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": {n: sh.to_full(n, g).detach().numpy().copy() for n, g in m["grads"].items()},
            "params": {k: v.detach().numpy().copy() for k, v in sh.full_state_dict().items()}}


def _checkpoint_case(data):
    """Restore the single-device checkpoint ``ckpt_a`` into a sharded
    trainer (its whole state back out), take a step, save ``ckpt_b``."""
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.parallel import make_mesh
    from ezaudio_tpu_torch.training.trainer import Trainer

    out = {}
    for opt in ("adamw", "adafactor"):
        tr = Trainer.create(tiny_dit(), DDIMSchedule.from_config(DIFF), opt_cfg(opt),
                            mesh=make_mesh(fsdp=2, tp=2))
        tr.restore_checkpoint(os.path.join(data["ckpt_a"], opt))
        # copies: a replicated parameter's whole value is the parameter itself
        out[opt] = {"model": {k: v.numpy().copy()
                              for k, v in tr.sharding.full_state_dict().items()},
                    "optimizer": _numpy(tr.optimizer.state_dict()), "step": tr.step}
        tr.train_step(train_batch(), 3)
        tr.save_checkpoint(os.path.join(data["ckpt_b"], opt))
        out[opt]["after"] = {k: v.numpy() for k, v in tr.sharding.full_state_dict().items()}
    return out


def _numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().copy()
    if isinstance(obj, dict):
        return {k: _numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_numpy(v) for v in obj)
    return obj


def _api_case():
    """EzAudio on three meshes (staged, fused, an edit), the ControlNet on a
    fsdp x tp base and a server on dp 4, each against its single-device
    run: the largest differences."""
    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.parallel import make_mesh
    from ezaudio_tpu_torch.parallel.dryrun import API_CONFIG, SR, VAE_CONFIG, _t5
    from ezaudio_tpu_torch.serving import GenerationServer

    kw = dict(config=API_CONFIG, t5_config=_t5(), vae_config=VAE_CONFIG, device="cpu")
    prompts = ["rain on a roof", "a dog", "wind"]
    gt = (0.5 * np.sin(2 * np.pi * 55 * np.arange(2 * SR) / SR)).astype(np.float32)
    edit = dict(boundary=0.25, gt_file=gt, mask_start=0.5, mask_length=0.5, ddim_steps=2,
                random_seed=4)
    solo = EzAudio(**kw)
    want = dict(staged=solo.generate_audio(prompts, length=1, ddim_steps=2, random_seed=7)[1],
                fused=solo.generate_audio(prompts, length=1, ddim_steps=2, random_seed=7,
                                          fused=True, sampler="dpm")[1],
                edit=solo.editing_audio("an edit", **edit)[1])
    errs = {}
    for name, shape in (("dp4", dict(dp=4)), ("dp2xfsdp2", dict(dp=2, fsdp=2)),
                        ("fsdp2xtp2", dict(fsdp=2, tp=2))):
        ez = EzAudio(mesh=make_mesh(**shape), **kw)
        got = dict(staged=ez.generate_audio(prompts, length=1, ddim_steps=2, random_seed=7)[1],
                   fused=ez.generate_audio(prompts, length=1, ddim_steps=2, random_seed=7,
                                           fused=True, sampler="dpm")[1],
                   edit=ez.editing_audio("an edit", **edit)[1])
        for k in want:
            errs[f"{name}/{k}"] = float(np.abs(got[k] - want[k]).max())
    cn_solo = EzAudioControlNet(**kw)
    cn_mesh = EzAudioControlNet(mesh=make_mesh(fsdp=2, tp=2), **kw)
    cw = [cn.generate_audio("a tone", gt, ddim_steps=2, random_seed=5)[1]
          for cn in (cn_solo, cn_mesh)]
    errs["controlnet/fsdp2xtp2"] = float(np.abs(cw[0] - cw[1]).max())

    def drain(ez):
        with GenerationServer(ez, max_batch_size=3, max_wait_ms=100, length=1.0,
                              ddim_steps=2, sampler="dpm") as srv:
            futs = [srv.submit(p, seed=3 + i) for i, p in enumerate(prompts)]
            futs.append(srv.submit_edit("an edit", gt, boundary=0.25, mask_start=0.5,
                                        mask_length=0.5, seed=6, ddim_steps=2))
            return srv.buckets, [np.asarray(f.result(timeout=120)[1]) for f in futs]

    mesh_ez = EzAudio(mesh=make_mesh(dp=4), **kw)
    (_, a), (buckets, b) = drain(solo), drain(mesh_ez)
    errs["server/dp4"] = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    return errs, buckets


def _train_cli_case(data, dtype="float32"):
    """``train_cli --mesh-fsdp 2 --dtype <dtype>``: its losses, and the rows
    that each call of the VAE encode and of T5 was given on this rank."""
    from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
    from ezaudio_tpu_torch.parallel.dryrun import VAE_CONFIG, _t5
    from ezaudio_tpu_torch.text.t5 import T5Encoder
    from ezaudio_tpu_torch.training import train_cli

    losses, rows = {}, {"encode": [], "t5": []}
    encode, t5_forward = AutoencoderFacade.encode, T5Encoder.forward

    def counted_encode(self, audio, *a, **kw):
        rows["encode"].append(len(audio))
        return encode(self, audio, *a, **kw)

    def counted_t5(self, ids, *a, **kw):
        rows["t5"].append(len(ids))
        return t5_forward(self, ids, *a, **kw)

    AutoencoderFacade.encode, T5Encoder.forward = counted_encode, counted_t5
    try:
        train_cli.main(["--config-name", data["cli_config"], "--max-steps", "2",
                        "--save-every-step", "100", "--save-dir", f"{data['cli_save']}/{dtype}",
                        "--log-dir", data["cli_log"], "--device", "cpu", "--mesh-fsdp", "2",
                        "--dtype", dtype],
                       t5_config=_t5(), vae_config=VAE_CONFIG,
                       on_step=lambda s, m: losses.__setitem__(s, float(m["loss"])))
    finally:
        AutoencoderFacade.encode, T5Encoder.forward = encode, t5_forward
    return {"losses": losses, "rows": rows}


def _int8_tp_case():
    """The tiny MaskDiT's forward with int8 products (every linear), placed
    by ``dit_param_shardings`` at fsdp 2 x tp 2 and whole: the largest
    difference over the largest output, and the quantized weights of a
    row split against the whole layer's, sliced."""
    import ezaudio_tpu_torch.ops.quant as quant
    from ezaudio_tpu_torch.parallel import make_mesh
    from ezaudio_tpu_torch.parallel.sharding import shard_dit

    quant.MIN_QUANT_ELEMENTS = 0
    whole, placed = tiny_dit().eval(), tiny_dit().eval()
    sh = shard_dit(make_mesh(fsdp=2, tp=2), placed)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((2, 32, 8)), dtype=torch.float32)
    ctx = torch.tensor(rng.standard_normal((2, 5, 24)), dtype=torch.float32)
    t = torch.tensor([100, 700])
    with torch.no_grad(), quant.quant_context("int8"):
        want = whole(x, t, ctx)[0]
        got = placed(x, t, ctx)[0]
    lin = placed.model.in_blocks[0].attn.proj  # a row split
    lin_whole = whole.model.in_blocks[0].attn.proj
    wq, ws = quant.quantize_symmetric(lin_whole.weight.detach().float(), -1)
    ok_w = (torch.equal(lin._wq[0], wq[:, lin.tp.index]) and torch.equal(lin._wq[1], ws))
    assert sh.placements["model.in_blocks.0.attn.proj.weight"].axis == "tp"
    return {"rel_err": float((got - want).abs().max() / want.abs().max()),
            "row_split_weight_equal": bool(ok_w)}


def _freed_case():
    """Whether a trainer's model outlives its last reference until the
    garbage collector runs: plain, on a mesh without FSDP2, wrapped in
    FSDP2 (fsdp 2)."""
    import gc
    import weakref

    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.parallel import make_mesh
    from ezaudio_tpu_torch.training.trainer import Trainer

    out = {}
    for name, mesh in (("warm", None), ("plain", None), ("dp4", make_mesh(dp=4)),
                       ("fsdp2", make_mesh(fsdp=2, tp=2))):
        gc.collect()
        gc.disable()
        try:
            model = tiny_dit()
            tr = Trainer.create(model, DDIMSchedule.from_config(DIFF), opt_cfg("adamw"),
                                mesh=mesh)
            tr.train_step(train_batch(), 3)
            ref = weakref.ref(model)
            del model, tr
            kept = ref() is not None
        finally:
            gc.enable()
        gc.collect()
        out[name] = (kept, ref() is not None)
    return out


def _parallel_cases(rank, data):
    from ezaudio_tpu_torch.parallel import make_mesh

    out = {"rows": _rows_case(rank), "int8_tp": _int8_tp_case(), "freed": _freed_case()}
    for name, shape in (("dp2xfsdp2", dict(dp=2, fsdp=2)), ("fsdp2xtp2", dict(fsdp=2, tp=2))):
        mesh = make_mesh(**shape)
        for opt in ("adamw", "adafactor"):
            out[f"train/{name}/{opt}"] = _train_case(mesh, opt)
    for name, shape, opts in (("dp2xfsdp2", dict(dp=2, fsdp=2), ("adamw", "adamw_mu_bf16")),
                              ("fsdp2xtp2", dict(fsdp=2, tp=2), ("adafactor",))):
        mesh = make_mesh(**shape)
        for opt in opts:
            kw = (dict(mu_dtype="bfloat16") if opt == "adamw_mu_bf16"
                  else dict(optimizer=opt))
            out[f"train_bf16/{name}/{opt}"] = _train_bf16_case(mesh, kw)
    out["bf16_wrapped"] = _bf16_wrapped_case(data)
    out["checkpoint"] = _checkpoint_case(data)
    out["api"] = _api_case()
    out["train_cli"] = _train_cli_case(data)
    out["train_cli_bf16"] = _train_cli_case(data, "bfloat16")
    return out


def parallel_rank(rank, path, data, q):
    _run_rank(_parallel_cases, rank, path, data, q, WORLD)


def _anchor_cases(rank, data):
    """The f32 step; the bf16 step and the f32 step (its rule's reference)
    of the bf16 case's model on its batch and noise rounded to bf16."""
    a = data["anchor"]
    out = _jax_anchor_case(a)
    out["bf16"] = _jax_anchor_case(a["bf16"], torch.bfloat16)
    out["bf16_ref"] = _jax_anchor_case(a["bf16"])
    return out


def anchor_rank(rank, path, data, q):
    _run_rank(_anchor_cases, rank, path, data, q, WORLD)

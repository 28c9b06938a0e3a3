"""The harness on the CPU at a tiny size: each cell runs through the port
and is correct; the control put in the program's place, and each fault
planted in the timed path, come out not correct under the cells' own
limits; nothing loads JAX or the JAX package.  The look for a chip is
skipped: the drivers are called as ``run.py`` calls them, on the CPU."""

import ast
import itertools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from conftest import BENCH, ROOT, data

from yardstick import drivers, loader

STEPS = 6  # the tiny cells' sampler steps
CELLS = {  # cell -> tiny overrides of its traffic
    "xl_t2a_b8_ddim100": dict(batch=4, seconds=0.2, recipe_steps=STEPS, check_steps_sampled=4),
    "l_t2a_b4_f32_ddim100": dict(batch=4, seconds=0.2, recipe_steps=STEPS),
}


def tiny_cell(name: str, dtype: str = "float32") -> dict:
    """The cell's traffic file, its limits kept, at the tiny size."""
    tr = loader.load_benchmark(ROOT).traffic(name)
    for key, value in CELLS[name].items():
        if key.startswith("recipe_"):
            tr["recipe"][key[7:]] = value
        else:
            tr[key] = value
    tr["dtype"] = dtype
    return tr


def run_tiny(name, hooks=None, control=None, seconds=0.5, dtype="float32", seed=2 ** 31 + 7):
    import run as harness

    ctx = drivers.Context(data("tiny"), tiny_cell(name, dtype), seed, seconds, False, "cpu",
                          time.perf_counter(), hooks)
    ctx.control = control
    r = drivers.run_cell(ctx)
    line = harness.result_line(loader.load_benchmark(ROOT), name, r, False,
                               dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0))
    return r, line


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_is_correct_through_the_port(name, tmpdir_env):
    r, line = run_tiny(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert {"setup_s", "audio_s_per_s"} == set(line["metrics"])
    assert r.calls and r.counters["launches"]


# At the tiny widths TF32's rounding does not build up as it does at s3_l's
# (the control reads 1e-3 to 4e-3 there against 0.057-0.072 on the card, where
# its limit is 0.0015), so the f32 cell's control is not tested at this size.
TINY_CONTROLS = sorted(set(CELLS) - {"l_t2a_b4_f32_ddim100"})


@pytest.mark.parametrize("name", TINY_CONTROLS)
def test_control_in_the_programs_place_is_not_correct(name, tmpdir_env):
    tr = tiny_cell(name)
    r, _ = run_tiny(name, control=tr["control"])
    read = {k[len("control."):]: v for k, v in r.counters.items() if k.startswith("control.")}
    assert read and any(v > tr["limits"][k] for k, v in read.items()), read


def _alter_answers(ez):
    generate = ez.generate_audio

    def altered(*a, **kw):
        sr, wav = generate(*a, **kw)
        wav = np.array(wav)
        wav[0] = 0.0  # an answer altered where it is produced
        return sr, wav

    ez.generate_audio = altered
    return ez


def _step_state_unchanged(ez):
    sched = ez.noise_scheduler
    step, count = sched.ddim_step, itertools.count()

    def frozen(model_output, sample, *a, **kw):
        # one sampler step of every call returns its latents unchanged
        if next(count) % STEPS == STEPS // 2:
            return sample.float()
        return step(model_output, sample, *a, **kw)

    object.__setattr__(sched, "ddim_step", frozen)  # the schedule is a frozen dataclass
    return ez


def _uncond_altered(ez):
    embed = ez.embed_text

    def altered(texts):
        out, mask = embed(texts)
        if all(t == "" for t in texts):  # the cached CFG uncond branch
            out = out * 1.5
        return out, mask

    ez.embed_text = altered
    return ez


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in sorted(CELLS)
    for fault in (_alter_answers, _step_state_unchanged, _uncond_altered)])
def test_a_planted_fault_is_not_correct(name, fault, tmpdir_env):
    _, line = run_tiny(name, hooks={"after_build": fault})
    assert not line["correct"], line["checks"]


def test_nothing_loads_jax_or_the_jax_package(tmpdir_env):
    code = ("import sys, time; sys.path[:0] = [%r, %r]\n"
            "import run, test_harness\n"
            "test_harness.run_tiny('xl_t2a_b8_ddim100')\n"
            "print(run.forbidden_modules())\n") % (BENCH, os.path.dirname(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "ezaudio_tpu"}
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(dirpath, f))}
                assert not tops & bad, (f, tops & bad)
                src = open(os.path.join(dirpath, f)).read()
                assert f == os.path.basename(__file__) or "bench.py" not in src
    # the port's name begins with the JAX package's and is not taken for it
    import ezaudio_tpu_torch  # noqa: F401
    import run

    assert "ezaudio_tpu_torch" in sys.modules and not run.forbidden_modules()


WORKLOADS = sorted(loader.load_benchmark(ROOT).workloads)


@pytest.mark.cuda
@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_on_the_card(name, cuda_card, tmpdir_env):
    """One short run of the cell from the checkout's root (the card only)."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          "2147483999", "--seconds", "5", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    import json

    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", WORKLOADS)
def test_control_on_the_card_is_not_correct(name, cuda_card, tmpdir_env, tmp_path):
    """The control in the program's place at the cell's own size (the card only)."""
    import json

    tr = loader.load_benchmark(ROOT).traffic(name)
    out_file = tmp_path / "cal.jsonl"
    out = subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload", name,
                          "--seeds", "2147483901", "--seconds", "1", "--control", tr["control"],
                          "--out", str(out_file)], cwd=ROOT, capture_output=True, text=True,
                         timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    read = json.loads(out_file.read_text().splitlines()[-1])["readings"]
    ctl = {k[len("control."):]: v for k, v in read.items() if k.startswith("control.")}
    assert any(v > tr["limits"][k] for k, v in ctl.items() if k in tr["limits"]), ctl

"""``python -m ezaudio_tpu_torch.parallel.dryrun`` (the torch analog of the
JAX package's ``dryrun_multichip``) at 4 CPU ranks: the train step over
dp2 x fsdp2, dp-sharded and dp x sp ring sampling, ``EzAudio(mesh=)`` and
every served path against single-device runs, within 1e-5."""

import re
import subprocess
import sys

import pytest

from ezaudio_tpu_torch.parallel import dryrun


def test_dryrun_at_four_cpu_ranks_prints_ok():
    line = dryrun.run(4, "cpu", timeout=300.0)
    assert line.startswith("dryrun(4): ok, loss=")
    assert "train dp2xfsdp2xtp1, cfg-dp, ring-sp2, api-mesh(dp4" in line
    errs = [float(x) for x in re.findall(r"=(\d\.\de[+-]\d\d)", line)]
    assert len(errs) == 7 and max(errs) < 1e-5, line


def test_dryrun_cli_refuses_more_ranks_than_cards():
    """``--device cuda`` needs a card per rank: without them it fails at
    once with exit code 1, spawning nothing."""
    proc = subprocess.run([sys.executable, "-m", "ezaudio_tpu_torch.parallel.dryrun",
                           "--procs", "2", "--device", "cuda"], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1
    assert "FAILED" in proc.stderr and "GPUs" in proc.stderr


@pytest.mark.parametrize("argv", [["--help"]])
def test_dryrun_help(argv, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 0 and "--procs" in capsys.readouterr().out

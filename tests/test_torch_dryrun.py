"""The port's ``entry.dryrun_multichip``, the twin of the JAX package's
``__graft_entry__.dryrun_multichip``: one step of the dp x tp x sp
training step with ring attention, GPipe's forward and backward on a pp
= 2 mesh and the 1F1B step, each finite, each printing its ``OK`` line:
on gloo worlds of eight and four processes (``device="cpu"``, started
by the port's launcher; eight as the JAX dry run's virtual devices),
and on four and two ranks emulated in one process (the card's route,
here on CPU tensors), whose losses are the gloo world's of the same
size.
"""

import re

import numpy as np
import pytest
import torch

from horovod_tpu_torch import entry

LINES = (r"dryrun_multichip OK: mesh dp=(\d+) tp=(\d+) sp=(\d+) "
         r"\((\d+) devices\), loss=(\S+)",
         r"dryrun pipeline OK: pp=2 dp=(\d+), loss=(\S+)",
         r"dryrun 1f1b OK: pp=2 dp=(\d+), loss=(\S+)")


def _ok_lines(text):
    found = [re.search(p, text) for p in LINES]
    assert all(found), text
    losses = [float(m.group(m.re.groups)) for m in found]
    assert all(np.isfinite(losses)), text
    return found, losses


@pytest.fixture(scope="module")
def gloo():
    """Rank 0's lines of the gloo worlds of 8 and 4."""
    return {n: "\n".join(entry._dryrun_processes(n)) for n in (8, 4)}


def test_dryrun_multichip_on_a_gloo_world_of_eight(gloo):
    (step, gpipe, f1b), _ = _ok_lines(gloo[8])
    assert step.groups()[:4] == ("2", "2", "2", "8")
    assert gpipe.group(1) == f1b.group(1) == "4"


def test_dryrun_multichip_prints_its_lines(capfd, monkeypatch, gloo):
    """``dryrun_multichip(n, device="cpu")`` prints rank 0's lines."""
    monkeypatch.setattr(entry, "_dryrun_processes",
                        lambda n: gloo[n].split("\n"))
    entry.dryrun_multichip(8, device="cpu")
    assert capfd.readouterr().out == gloo[8] + "\n"


@pytest.mark.parametrize("n", [2, 4])
def test_emulated_dryrun(capfd, gloo, n):
    """The emulated ranks' lines: finite, the factors of ``n``; at four,
    the gloo world's losses."""
    torch.set_num_threads(1)
    entry._dryrun_emulated(n, torch.device("cpu"))
    (step, gpipe, _), emulated = _ok_lines(capfd.readouterr().out)
    want = tuple(map(str, entry.dryrun_factors(n) + (n,)))
    assert step.groups()[:4] == want
    assert gpipe.group(1) == str(n // 2)
    if n in gloo:
        assert emulated == _ok_lines(gloo[n])[1]


def test_dryrun_factors_are_the_jax_dry_runs():
    assert [entry.dryrun_factors(n) for n in (1, 2, 4, 8, 6)] == [
        (1, 1, 1), (1, 1, 2), (1, 2, 2), (2, 2, 2), (3, 1, 2)]
    with pytest.raises(ValueError, match="data axis"):
        entry._dryrun_emulated(8, torch.device("cpu"))

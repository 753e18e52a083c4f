"""The port's 1F1B schedule (``parallel/pipeline.py``
``pipeline_lm_train_step_1f1b``) against the JAX package's, in a world
of four.

Four worker processes over gloo (``torch_pipeline_world``: the JAX
pipeline tests' tiny GPT-2, float32, the same flax weights) run 1F1B at
(pp 2 x dp 2, M 4), (pp 2 x dp 2, M 8, B 16: the input ring reused) and
(pp 4, M 2: a pipeline deeper than its microbatches), and at (pp 4, M
4) with the last microbatch's targets all padding and with padding
spread unevenly. The JAX package runs ``pipeline_lm_train_step_1f1b`` on
the same meshes over four of the conftest's CPU devices (the padded
cases: only against the serial model, as its own padding tests hold
it), and ``jax.grad`` of the serial model. Held at the JAX tests' tolerances: the
loss within 1e-5 relative, every gradient a rank holds within rtol
3e-3, atol 3e-4 of both; the replicated parameters' gradients bitwise
the same on every rank; the (pp 2 x dp 2, M 4) step on four ranks
emulated in this process bitwise the gloo world's.
"""

import numpy as np
import pytest
import torch

import torch_pipeline_world as tw

torch.set_num_threads(1)

#: name -> (pp, dp, microbatches, schedule, tokens)
SCENARIOS = {
    "pp2_dp2_m4": (2, 2, 4, "1f1b", "plain8"),
    "pp2_dp2_m8_b16": (2, 2, 8, "1f1b", "plain16"),
    "pp4_m2": (4, 1, 2, "1f1b", "plain8"),
    "fully_padded_microbatch": (4, 1, 4, "1f1b", "pad_full"),
    "uneven_padding": (4, 1, 4, "1f1b", "pad_uneven"),
}
#: held against the serial model only, as the JAX package's padding tests
#: hold its 1F1B step
SERIAL_ONLY = ("fully_padded_microbatch", "uneven_padding")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tw.start_world(tmp_path_factory.mktemp("pipeline_1f1b"),
                          SCENARIOS, serial_only=SERIAL_ONLY)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_1f1b_matches_jax_and_serial(world, name):
    tw.check_scenario(world, name)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replicated_gradients_are_bitwise_the_same_on_every_rank(world,
                                                                 name):
    tw.check_replicated_bitwise(world, name)


def test_emulated_world_is_bitwise_the_gloo_world(world):
    tw.check_emulated(world, "pp2_dp2_m4")


def test_fully_padded_microbatch_counts_zero(world):
    """A microbatch with no valid target adds 0 to the denominator, not
    the 1 a clamped per-microbatch count would add: the loss is the
    serial model's, not Σ nll / (n + 1)."""
    toks = world["tokens"]["pad_full"]
    n = int((toks[:, 1:] != -1).sum())
    sloss = world["serial"]["pad_full"][0]
    got = world["ranks"][0]["fully_padded_microbatch"]["loss"]
    np.testing.assert_allclose(got, sloss, rtol=tw.LOSS_RTOL)
    assert abs(got - sloss * n / (n + 1)) > 1e-3

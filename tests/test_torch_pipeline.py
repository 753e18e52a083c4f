"""The port's GPipe schedule (``parallel/pipeline.py``) against the JAX
package's, in a world of four; the stage model, the stack interchange,
the chain hops and the pipeline's refusals.

Four worker processes over gloo (``torch_pipeline_world``: the JAX
pipeline tests' tiny GPT-2, float32, the same flax weights) run GPipe
(``pipeline_lm_train_step_gpipe``: ``pipeline_lm_apply``, the mean loss
and its backward; and ``pipeline_lm_apply``'s logits under
``no_grad``) on ``pp=4`` and ``pp=2,dp=2``, 25 GPipe and 30 1F1B steps
of Adam that must learn as the JAX tests' do, and the chain hops of
``parallel/comm.GroupComm``. The JAX package computes
``pipeline_lm_apply`` and ``jax.grad`` through it on the same meshes
over four of the conftest's CPU devices, and ``jax.grad`` of the serial
model. Held at the JAX tests' tolerances: logits within 2e-4, the loss
within 1e-5 relative, every gradient a rank holds within rtol 3e-3,
atol 3e-4 of both; the replicated parameters' gradients bitwise the
same on every rank; the same steps on four ranks emulated in this
process bitwise the gloo world's.
"""

import jax
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import pipeline as jpipe

import torch_pipeline_world as tw
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.parallel import comm as pc
from horovod_tpu_torch.parallel import mesh as pm
from horovod_tpu_torch.parallel import pipeline as pl

torch.set_num_threads(1)

#: name -> (pp, dp, microbatches, schedule, tokens)
SCENARIOS = {
    "gpipe_pp4": (4, 1, 2, "gpipe", "plain8"),
    "gpipe_pp2_dp2": (2, 2, 2, "gpipe", "plain8"),
}
#: schedule -> (config, tokens, steps, lr, microbatches): the JAX tests'
LEARN = {"gpipe": (dict(tw.CFG, num_layers=2, vocab_size=64,
                        max_seq_len=16), "table16", 25, 3e-3, 2),
         "1f1b": (dict(tw.CFG, num_layers=2), "plain8", 30, 1e-2, 4)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tw.start_world(tmp_path_factory.mktemp("pipeline"), SCENARIOS,
                          LEARN)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_gpipe_matches_jax_and_serial(world, name):
    tw.check_scenario(world, name)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replicated_gradients_are_bitwise_the_same_on_every_rank(world,
                                                                 name):
    tw.check_replicated_bitwise(world, name)


def test_emulated_world_is_bitwise_the_gloo_world(world):
    tw.check_emulated(world, "gpipe_pp2_dp2")


def test_pipelined_training_learns(world):
    """The JAX tests' convergence bars on pp=2 x dp=2: GPipe, 25 steps
    of Adam(3e-3) on a fixed-successor batch, falls by 0.5; 1F1B, 30
    steps of Adam(1e-2), halves; every rank the same losses."""
    for r in range(tw.N):
        g = world["ranks"][r]["learn_gpipe"]
        f = world["ranks"][r]["learn_1f1b"]
        assert g[-1] < g[0] - 0.5, g
        assert f[-1] < f[0] * 0.5, f
        assert g == world["ranks"][0]["learn_gpipe"]
        assert f == world["ranks"][0]["learn_1f1b"]


def test_chain_hops_over_gloo(world):
    """``hop_forward``: rank i's tensor to i + 1, zeros into stage 0;
    ``hop_backward``: i + 1's to i, zeros into the last stage; over the
    pp slices of a pp=2 x dp=2 mesh (ranks 0, 2 and 1, 3)."""
    for r in range(tw.N):
        fwd, bwd = world["ranks"][r]["hops"]
        stage = r // 2
        want_f = 0.0 if stage == 0 else float(r - 2 + 1)
        want_b = 0.0 if stage == 1 else float((r + 2 + 1) * 10)
        assert torch.equal(fwd, torch.full((3,), want_f)), (r, fwd)
        assert torch.equal(bwd, torch.full((3,), want_b)), (r, bwd)


def test_chain_hops_emulated_and_alone():
    """The same hops between threads (``ThreadComm``), and an axis of
    one (``SelfComm``), which receives zeros both ways."""
    world = pc.ThreadWorld(3, timeout=30.0)

    def rank(r):
        c = pc.ThreadComm(world, r)
        x = torch.full((2,), float(r + 1))
        return c.hop_forward(x), c.hop_backward(x)

    got = pc.run_ranks([world], rank, 3)
    assert [float(f[0]) for f, _ in got] == [0.0, 1.0, 2.0]
    assert [float(b[0]) for _, b in got] == [2.0, 3.0, 0.0]
    x = torch.ones(2)
    assert torch.equal(pc.SelfComm().hop_forward(x), torch.zeros(2))
    assert torch.equal(pc.SelfComm().hop_backward(x), torch.zeros(2))


def test_stack_round_trip_against_jax(world):
    """``stack_block_params``/``unstack_block_params`` on the port's
    dotted names: the stack bitwise the JAX package's, the round trip
    bitwise the input, and a stage's local stack with its first block's
    index."""
    params = world["params"]
    jstacked, jrest = jpipe.stack_block_params(params)
    state = params_from_flax(params)
    stacked, rest = pl.stack_block_params(state)
    want = params_from_flax(jax.tree.map(np.asarray, jstacked))
    assert set(stacked) == set(want)
    for k, v in stacked.items():
        assert torch.equal(v, want[k]), k
    assert set(rest) == set(params_from_flax(jrest))
    back = pl.unstack_block_params(stacked, rest)
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    local = {k: v for k, v in state.items()
             if not k.startswith(("block_0.", "block_3."))}
    lstack, lrest = pl.stack_block_params(local)
    assert next(iter(lstack.values())).shape[0] == 2
    again = pl.unstack_block_params(lstack, lrest, first=1)
    assert set(again) == set(local)
    for k, v in local.items():
        assert torch.equal(again[k], v), k


def test_stage_holds_its_blocks_with_the_whole_models_weights():
    """``build_stage``: blocks [s·L/S, (s+1)·L/S) under their global
    names plus the replicated rest, each the whole model's draw from the
    same seed; a stage's forward alone refuses."""
    cfg = tt.TransformerConfig(dtype=torch.float32, **tw.CFG)
    whole = tt.Transformer(cfg).init_params(
        torch.Generator().manual_seed(3)).state_dict()
    layout = pm.make_mesh(world=tw.N, pp=4)
    for r in range(tw.N):
        mesh = pm.Mesh(layout.axis_names, layout.shape, r,
                       comms={"pp": pc.SelfComm()})
        stage = pl.build_stage(cfg, mesh, device="cpu", seed=3)
        assert stage.layers == range(r, r + 1)
        state = stage.state_dict()
        assert {k.split(".")[0] for k in state if k.startswith("block_")} \
            == {f"block_{r}"}
        for k, v in state.items():
            assert torch.equal(v, whole[k]), (r, k)
        with pytest.raises(ValueError, match="pipeline stage"):
            stage(torch.zeros((1, 4), dtype=torch.long))


def test_refusals():
    """The JAX ``_check_pp``'s (no pp axis; layers the stages do not
    divide; a batch the microbatches do not divide) and the port's own
    (a live axis beyond pp and the data axes; a model of another
    stage)."""
    cfg = tt.TransformerConfig(dtype=torch.float32, **tw.CFG)

    def mesh(rank=0, **axes):
        names, shape = zip(*axes.items())
        return pm.Mesh(names, shape, rank,
                       comms={a: pc.SelfComm() for a in names})

    tokens = torch.zeros((8, 32), dtype=torch.long)
    with pytest.raises(ValueError, match="needs a 'pp' mesh axis"):
        pl.build_stage(cfg, mesh(dp=2), device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3 pipeline"):
        pl.build_stage(cfg, mesh(pp=3), device="cpu")
    with pytest.raises(ValueError, match="only repeat"):
        pl.build_stage(cfg, mesh(pp=2, tp=2), device="cpu")
    stage = pl.build_stage(cfg, mesh(pp=2), device="cpu")
    for fn in (pl.pipeline_lm_apply, pl.pipeline_lm_train_step_1f1b,
               pl.pipeline_lm_train_step_gpipe):
        with pytest.raises(ValueError, match="not divisible by microbatches"):
            fn(cfg, stage, tokens, mesh(pp=2), 3)
        with pytest.raises(ValueError, match="holds blocks"):
            fn(cfg, stage, tokens, mesh(rank=1, pp=2), 2)
        with pytest.raises(ValueError, match="needs a 'pp' mesh axis"):
            fn(cfg, stage, tokens, mesh(dp=2), 2)


def test_transformer_holds_a_range_of_blocks():
    cfg = tt.TransformerConfig(dtype=torch.float32, **tw.CFG)
    with pytest.raises(ValueError, match="not a range"):
        tt.Transformer(cfg, layers=range(2, 6))
    assert hvd.parallel.stage_layers(
        tt.TransformerConfig(**dict(tw.CFG, num_layers=24)),
        pm.make_mesh(world=4, pp=4), rank=2) == range(12, 18)

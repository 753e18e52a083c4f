"""The port's gradient bucket plan is the JAX package's, leaf for leaf.

``horovod_tpu.ops.fusion.pytree_bucket_plan`` plans over
``tree_flatten_with_path`` of the flax parameter tree (sorted keys:
``block_10`` before ``block_2``); the port plans over its
``named_parameters()`` mapped to flax paths. For the same model the two
plans must be identical (leaf index, offset, size, shape in every
bucket) at the default 128 MiB threshold, at 64 KiB (several buckets)
and at 4 KiB, with the backward-availability order on and off. A
12-layer model makes the sorted order differ from the numeric one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import fusion as tfusion

torch.set_num_threads(1)

_KW = dict(num_layers=12, num_heads=2, hidden_size=32, max_seq_len=16,
           vocab_size=61)
_LLAMA = dict(_KW, num_kv_heads=1, norm="rmsnorm", position="rope",
              activation="swiglu", tie_embeddings=False)


def _trees(kw):
    jmod = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **kw))
    abstract = jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0),
                          jnp.ones((1, 4), jnp.int32))["params"])
    tmod = tt.Transformer(tt.TransformerConfig(dtype=torch.float32, **kw))
    named = list(tmod.named_parameters())
    paths = [tfusion.flax_path(n) for n, _ in named]
    order = tfusion.flatten_order(paths)
    leaves = [(paths[i], tuple(named[i][1].shape), named[i][1].dtype)
              for i in order]
    return abstract, leaves


def _plain(plans):
    return [[(int(i), int(o), int(n), tuple(int(d) for d in s))
             for (i, o, n, s) in bucket] for bucket in plans]


@pytest.mark.parametrize("kw", [_KW, _LLAMA], ids=["gpt2", "llama"])
@pytest.mark.parametrize("threshold", [128 * 1024 * 1024, 64 * 1024, 4096])
@pytest.mark.parametrize("backward_order", [True, False])
def test_plan_equals_jax(kw, threshold, backward_order):
    abstract, leaves = _trees(kw)
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(abstract)[0]]
    assert jpaths == [tfusion.keystr(p) for p, _, _ in leaves]
    _, jplans = jfusion.pytree_bucket_plan(
        abstract, threshold_bytes=threshold, backward_order=backward_order)
    tplans = tfusion.pytree_bucket_plan(
        leaves, threshold_bytes=threshold, backward_order=backward_order)
    assert _plain(tplans) == _plain(jplans)
    if threshold == 4096:
        assert len(tplans) > 10


def test_backward_order_puts_head_first_and_embeddings_last():
    _, leaves = _trees(_KW)
    order = tfusion._backward_availability_order([p for p, _, _ in leaves])
    names = [".".join(leaves[i][0]) for i in order]
    assert names[0].startswith("ln_final")
    assert names[-1] in ("tok_emb.embedding", "pos_emb")
    blocks = [int(n.split(".")[0][6:]) for n in names
              if n.startswith("block_")]
    assert blocks == sorted(blocks, reverse=True)


def test_pack_and_unflatten_round_trip():
    _, leaves = _trees(dict(_KW, num_layers=2))
    rs = np.random.RandomState(0)
    tensors = [torch.from_numpy(rs.randn(*shape).astype(np.float32))
               for _, shape, _ in leaves]
    plans = tfusion.pytree_bucket_plan(leaves, threshold_bytes=2048,
                                       backward_order=True)
    buckets = tfusion.pack_buckets_by_plan(tensors, plans)
    assert [b.numel() for b in buckets] == [
        sum(n for (_, _, n, _) in p) for p in plans]
    back = tfusion.unflatten_buckets_by_plan(buckets, plans, len(tensors))
    for a, b in zip(tensors, back):
        assert torch.equal(a, b)


def test_plan_defaults_follow_the_knobs(monkeypatch):
    _, leaves = _trees(dict(_KW, num_layers=2))
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "4096")
    monkeypatch.setenv("HOROVOD_BUCKET_BACKWARD_ORDER", "0")
    assert tfusion.pytree_bucket_plan(leaves) == tfusion.pytree_bucket_plan(
        leaves, threshold_bytes=4096, backward_order=False)

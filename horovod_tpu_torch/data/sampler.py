"""Elastic sampler: skip already-processed samples after a world resize.

The port of ``horovod_tpu/data/sampler.py`` (numpy only), which gives
the JAX sampler's index sequences. Reference
horovod/torch/elastic/sampler.py:24
(`ElasticSampler`): shards indices over ranks, records processed batches
via `record_batch`, and `set_epoch`/reshuffles so a resumed epoch skips
seen data.

State is **rank-symmetric** by construction: the epoch's shuffle order is
identical on every rank (same seed), and progress is a single global
cursor `processed_num` advanced by ``batch_size * num_replicas`` per
recorded batch — the reference's design. That makes `state_dict` identical
everywhere, so the elastic resync (broadcast rank 0's state) is lossless;
per-rank index *sets* would diverge and forget other ranks' progress.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class ElasticSampler:
    def __init__(self, dataset_size: int, shuffle: bool = True, seed: int = 0):
        self.dataset_size = dataset_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_num = 0  # global samples consumed this epoch
        self._rank = 0
        self._num_replicas = 1
        self._reset()

    # world hooks (reference sampler.py set_epoch / on reset) ------------

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed_num = 0
        self._reset()

    def set_world(self, rank: int, num_replicas: int) -> None:
        self._rank = rank
        self._num_replicas = num_replicas
        self._reset()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """Advance the global cursor by one per-rank batch: every rank
        consumed `batch_size` samples in lockstep."""
        del batch_idx  # progress is cumulative, not positional
        self.processed_num = min(
            self.processed_num + batch_size * self._num_replicas,
            self.dataset_size,
        )

    @property
    def processed_indices(self) -> List[int]:
        """Globally-processed sample indices (prefix of the epoch order)."""
        return [int(i) for i in self._order[: self.processed_num]]

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        if "processed_num" in state:
            self.processed_num = state["processed_num"]
        else:
            # legacy checkpoints stored rank 0's *local* index set, recorded
            # under the world size at save time. Scale by that if present;
            # after an elastic resize the current replica count says nothing
            # about the recording-time world, so with no record err LOW
            # (replaying a few samples is recoverable, skipping them is not).
            recorded = state.get("num_replicas")
            if recorded is None:
                from ..utils.logging import get_logger

                get_logger().warning(
                    "ElasticSampler: legacy checkpoint without a recorded "
                    "world size; resuming at the unscaled local cursor "
                    "(some samples may be replayed)."
                )
                recorded = 1
            self.processed_num = min(
                len(state["processed_indices"]) * recorded,
                self.dataset_size,
            )
        self._reset()

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "processed_num": self.processed_num,
            # recording-time world size: lets load_state_dict reconstruct
            # the cursor correctly even across an elastic resize
            "num_replicas": self._num_replicas,
        }

    # iteration ----------------------------------------------------------

    def _reset(self) -> None:
        order = np.arange(self.dataset_size)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        self._order = order
        remaining = [int(i) for i in order[self.processed_num:]]
        # pad so every replica sees the same count (repeat as many times as
        # needed — near epoch end fewer samples than replicas may remain)
        n = len(remaining)
        per = (n + self._num_replicas - 1) // self._num_replicas
        target = per * self._num_replicas
        if remaining:
            while len(remaining) < target:
                remaining += remaining[: target - len(remaining)]
        self.indices: List[int] = remaining[self._rank::self._num_replicas]

    def __len__(self) -> int:
        return len(self.indices)

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

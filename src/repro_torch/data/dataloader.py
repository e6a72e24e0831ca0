"""Distributed Dataloader (paper §6.1, Fig. 6): the port of
``repro.data.dataloader``.

Each worker materializes only its own partition of the dataset: on a rank
mesh each rank reads only its rows of the global batch, split over the
mesh's data axes (``dp_spec``); on one device that partition is the whole
batch. A deterministic epoch-seeded
permutation gives the global shuffle without any coordination: every worker
derives the identical permutation from (seed, epoch), the same numpy draw as
the JAX loader's, so both packages serve the same rows at every step.

Rows are built in numpy and moved to the mesh's device. On CUDA they are
staged in pinned host memory and copied with ``non_blocking=True``, so with
``prefetch=k`` the copies for the next ``k`` steps overlap the consumer's
work on the card, as the JAX loader's asynchronous ``device_put`` does.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional

import numpy as np
import torch


class DistributedDataloader:
    def __init__(
        self,
        dataset,
        *,
        mesh,
        global_batch: int,
        seed: int = 0,
        prefetch: int = 0,
    ):
        self.dataset = dataset
        self.mesh = mesh
        # the rows split over the mesh's data axes, as the model stages read them
        self.dp_spec = (tuple(a for a in mesh.axis_names if a != "model"),)
        self.global_batch = global_batch
        self.seed = seed
        self.step = 0
        self.rows_loaded = 0  # local accounting (tests / Fig. 6 property)
        self._excluded: set = set()  # straggler mitigation (ft.straggler)
        # look-ahead depth (paper §6.2 double buffering on the load side):
        # with prefetch=k, the batch for step s+k is materialized (its rows
        # read and its copy to the device issued) while the consumer
        # computes step s.
        self.prefetch = prefetch
        self._built_step = 0  # next step a build will materialize
        self._ready: Deque[Dict[str, torch.Tensor]] = deque()
        self.prefetch_hits = 0  # batches served from the look-ahead queue

    # ------------------------------------------------------------------ #
    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.dataset))

    def batch_indices(self, step: Optional[int] = None) -> np.ndarray:
        step = self.step if step is None else step
        bs = self.global_batch
        steps_per_epoch = max(len(self.dataset) // bs, 1)
        epoch, within = divmod(step, steps_per_epoch)
        perm = self._epoch_perm(epoch)
        lo = (within * bs) % max(len(self.dataset) - bs + 1, 1)
        return perm[lo : lo + bs]

    # ------------------------------------------------------------------ #
    def next_batch(self) -> Dict[str, torch.Tensor]:
        """Return the batch for the current step, then advance. With
        ``prefetch > 0`` the returned batch was (except on the very first
        call) already materialized during an earlier call; the batches for
        the next ``prefetch`` steps are issued before returning. Batch
        CONTENT is a pure function of the step index, so prefetch depth
        never changes what is returned, only when it is built."""
        if self.prefetch <= 0:
            batch = self._build_batch(self.step)
            self.step += 1
            return batch
        served_from_queue = bool(self._ready)
        while self._built_step <= self.step + self.prefetch:
            self._ready.append(self._build_batch(self._built_step))
            self._built_step += 1
        batch = self._ready.popleft()
        if served_from_queue:
            self.prefetch_hits += 1
        self.step += 1
        return batch

    def _build_batch(self, step: int) -> Dict[str, torch.Tensor]:
        idx = self.batch_indices(step)
        if getattr(self.mesh, "torch_mesh", None) is not None:
            from repro_torch.distributed import collectives

            idx = idx[collectives.region(self.mesh, idx.shape, self.dp_spec)[0]]
        rows = self.dataset.get_rows(idx)
        if isinstance(rows, tuple):
            prompts, answers = rows
            return {"prompts": self._to_device(prompts), "answers": self._to_device(answers)}
        return {"tokens": self._to_device(rows)}

    def _to_device(self, host_rows: np.ndarray) -> torch.Tensor:
        self.rows_loaded += len(host_rows)
        t = torch.from_numpy(np.ascontiguousarray(host_rows))
        if self.mesh.device.type == "cuda":
            return t.pin_memory().to(self.mesh.device, non_blocking=True)
        return t.to(self.mesh.device)

    # ------------------------------------------------------------------ #
    # straggler mitigation hook (ft/straggler.py): re-partition the epoch
    # permutation away from excluded (slow/dead) dp ranks.
    def exclude_ranks(self, ranks) -> None:
        self._excluded.update(ranks)

"""Batched inference on one model replica per device (counterpart of
``mural_tpu/parallel/sharded_predict.py``).

The JAX package runs one jitted eval step with the batch sharded over a
1-D mesh.  Here one process holds an eval-mode replica of the model on
each device of the list.  A batch is rounded up to ``per = ceil(B / n)``
rows per replica, as the JAX package rounds it; each replica's rows are
built and uploaded by a prefetch thread of its own, and each replica's
forward is enqueued on its device without a host sync.  The logits come
to the host once, at the end, and the padding rows are dropped.

With ``fused_inference`` each replica folds its own BN-folded forward
once, and K1 runs on the replica's card.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from mural_tpu_torch.data.batcher import segment_pool_batches
from mural_tpu_torch.data.prefetch import prefetch
from mural_tpu_torch.parallel.mesh import shard_rows
from mural_tpu_torch.train.steps import masked_ce_sum, model_input


def replica_forward(model: torch.nn.Module, device,
                    fused_inference: bool = False) -> Callable:
    """An eval-mode copy of ``model`` on ``device`` as ``forward(cat,
    codes, cont, tracks) -> logits``; the BN-folded forward (K1 on a
    card) with ``fused_inference``."""
    replica = copy.deepcopy(model).to(device).eval()
    if fused_inference:
        from mural_tpu_torch.ops.fused_inference import (fold_snv2,
                                                         snv2_fused_forward)
        folded = fold_snv2(replica)

        def forward(cat, codes, cont, tracks):
            return snv2_fused_forward(folded, cat, codes)
    else:
        def forward(cat, codes, cont, tracks):
            return replica(cat, model_input(codes, False, tracks), cont)
    return forward


def sharded_predict(model: torch.nn.Module, ds, batch_size: int,
                    devices: Sequence, fused_inference: bool = False,
                    n_class: int = 0) -> Tuple[np.ndarray, float]:
    """Predict every site of ``ds`` on a replica of ``model`` on each of
    ``devices`` (from :func:`~mural_tpu_torch.parallel.mesh.make_devices`;
    a device may repeat): ``(logits (n_sites, n_class) in dataset order,
    loss sum)``."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    per = -(-batch_size // n)
    eff_batch = per * n
    forwards = [replica_forward(model, d, fused_inference) for d in devices]
    feeds = [prefetch(segment_pool_batches(
        ds, 1, eff_batch, shuffle=False, pad_final=True,
        shard=shard_rows(eff_batch, n, i)), d)
        for i, d in enumerate(devices)]
    parts: List[torch.Tensor] = []
    losses = [torch.zeros((), dtype=torch.float32, device=d)
              for d in devices]
    with torch.inference_mode():
        for shards in zip(*feeds):
            for i, db in enumerate(shards):
                logits = forwards[i](db.cat, db.distal, db.cont,
                                     db.distal_tracks)
                losses[i] += masked_ce_sum(logits, db.y, db.mask)
                parts.append(logits[:db.n_valid])
        total_loss = float(sum(float(v) for v in losses))
        if not parts:
            return np.zeros((0, n_class), np.float32), total_loss
        return (np.concatenate([p.cpu().numpy() for p in parts]),
                total_loss)

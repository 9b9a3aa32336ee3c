"""The port's prefetch thread (``mural_tpu_torch/data/prefetch.py``) on
the CPU: the batches and their order equal ``segment_pool_batches``',
K-groups stack K batches and the leftovers come single, the rng ends
where the inline loop leaves it, an abandoned consumer stops the worker
and a worker exception re-raises in the consumer."""
import threading
import time

import numpy as np
import pytest
import torch

from mural_tpu_torch.data.batcher import Batch, segment_pool_batches
from mural_tpu_torch.data.dataset import prepare_dataset
from mural_tpu_torch.data.prefetch import (DeviceBatch, StackedDeviceBatch,
                                           prefetch, prefetch_stacked,
                                           stacked_inputs)
from test_torch_port_tracks import write_genome


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_prefetch")
    fasta, bed = write_genome(base, np.random.default_rng(4),
                              {"chr1": 20_000, "chr2": 6_000}, 150)
    return prepare_dataset(bed, fasta, central_bp=2000, local_radius=3,
                           local_order=2, distal_radius=40)


def _same(db, b: Batch):
    np.testing.assert_array_equal(db.y.numpy(), b.y)
    np.testing.assert_array_equal(db.cat.numpy(), b.cat)
    np.testing.assert_array_equal(db.distal.numpy(), b.distal)
    np.testing.assert_array_equal(
        db.mask.numpy(), (np.arange(len(b.y)) < b.n_valid).astype(np.float32))
    assert db.n_valid == b.n_valid
    assert db.y.dtype == db.cat.dtype == torch.int64
    assert db.distal.dtype == torch.uint8


@pytest.mark.parametrize("shuffle,pad_final", [(True, False),
                                               (False, True)])
def test_prefetch_yields_the_inline_batches(ds, shuffle, pad_final):
    """Same batches in the same order, and the rng left where the inline
    loop leaves it (the worker draws the same numbers)."""
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    want = list(segment_pool_batches(ds, 3, 32, shuffle=shuffle, rng=rng_a,
                                     pad_final=pad_final))
    got = list(prefetch(segment_pool_batches(
        ds, 3, 32, shuffle=shuffle, rng=rng_b, pad_final=pad_final), "cpu"))
    assert len(got) == len(want) > 4
    for db, b in zip(got, want):
        assert isinstance(db, DeviceBatch)
        _same(db, b)
        np.testing.assert_array_equal(db.rows, b.rows)
    assert rng_a.integers(1 << 30) == rng_b.integers(1 << 30)


@pytest.mark.parametrize("k", [5, 8])
def test_prefetch_stacked_groups_and_leftovers(ds, k):
    """Groups of k stacked on a leading axis, then the last n % k batches
    one by one; ``stacked_inputs`` gives both a leading axis."""
    want = list(segment_pool_batches(ds, 3, 32, shuffle=True,
                                     rng=np.random.default_rng(2)))
    got = list(prefetch_stacked(segment_pool_batches(
        ds, 3, 32, shuffle=True, rng=np.random.default_rng(2)), k, "cpu"))
    n_groups, n_left = divmod(len(want), k)
    assert n_left and len(got) == n_groups + n_left
    for g, db in enumerate(got[:n_groups]):
        assert isinstance(db, StackedDeviceBatch) and db.k == k
        assert db.n_valids == [32] * k
        for i in range(k):
            _same(DeviceBatch({"y": db.y[i], "cat": db.cat[i],
                               "distal": db.distal[i], "mask": db.mask[i],
                               "cont": None, "distal_tracks": None},
                              32, None), want[g * k + i])
        assert [t is None for t in stacked_inputs(db)] == [
            False, False, False, False, True, True]
    for db, b in zip(got[n_groups:], want[n_groups * k:]):
        assert type(db) is DeviceBatch
        _same(db, b)
        inputs = stacked_inputs(db)
        assert inputs[0].shape == (1, 32) and inputs[2].shape[0] == 1


def _batches(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise ValueError(f"bad batch {i}")
        yield Batch(y=np.full(4, i, np.int32), cat=np.zeros((4, 2), np.int32),
                    distal=np.zeros((4, 5), np.uint8), n_valid=4,
                    rows=np.arange(4))


def _workers():
    return [t for t in threading.enumerate() if t.name == "mural-prefetch"]


@pytest.mark.parametrize("stacked", [False, True])
def test_abandoned_consumer_stops_the_worker(stacked):
    before = set(_workers())
    it = (prefetch_stacked(_batches(10 ** 6), 2, "cpu", size=2) if stacked
          else prefetch(_batches(10 ** 6), "cpu", size=2))
    for i, db in enumerate(it):
        if i == 3:
            break
    del it
    deadline = time.time() + 10
    while set(_workers()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not set(_workers()) - before


@pytest.mark.parametrize("stacked", [False, True])
def test_worker_exception_reraises_in_the_consumer(stacked):
    it = (prefetch_stacked(_batches(9, fail_at=5), 2, "cpu") if stacked
          else prefetch(_batches(9, fail_at=5), "cpu"))
    seen = []
    with pytest.raises(ValueError, match="bad batch 5"):
        for db in it:
            seen.append(db.y.reshape(-1)[0].item())
    assert seen == ([0, 2] if stacked else [0, 1, 2, 3, 4])

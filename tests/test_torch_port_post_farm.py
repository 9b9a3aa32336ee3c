"""The port's output farm (mural_tpu_torch.predict.post_farm) against the
JAX package's: the same bytes on the same logits and one mural_tpu-
pickled FullDirichlet calibrator read through each package's
``load_calibrator``, inline and with two spawned workers (exact, the
gzip members included); a worker's error and a dead worker raise in the
main process instead of hanging; ``auto_n_workers`` is the JAX policy."""
import gzip
import pickle

import numpy as np
import pytest

from mural_tpu.calibrate.dirichlet import FullDirichletCalibrator
from mural_tpu.predict import post_farm as jfarm
from mural_tpu.train.checkpoint import load_calibrator as j_load_calibrator
from mural_tpu_torch.predict import post_farm
from mural_tpu_torch.train.checkpoint import load_calibrator

HEADER = ["chrom", "start", "end", "strand", "mut_type", "prob0", "prob1",
          "prob2", "prob3"]


def _chunks(rng):
    """Chunks on three chromosomes (one named ``1``), sizes 1 to 700."""
    out = []
    for i, n in enumerate((700, 1, 64, 333, 17, 250)):
        pos = np.sort(rng.integers(0, 10 ** 8, n))
        out.append((("chr1", "1", "chrX")[i % 3], pos, rng.random(n) < 0.5,
                    (3 * rng.normal(size=(n, 4))).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def calibrators(tmp_path_factory):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(500, 4))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    path = tmp_path_factory.mktemp("farm") / "model.fdiri_cal.pkl"
    with open(path, "wb") as fh:
        pickle.dump(FullDirichletCalibrator().fit(probs,
                                                  rng.integers(0, 4, 500)),
                    fh)
    return j_load_calibrator(str(path)), load_calibrator(str(path))


def _run(farm_module, path, chunks, **kw):
    farm = farm_module.PostprocessFarm(str(path), HEADER, **kw)
    for chunk in chunks:
        farm.submit(*chunk)
    return farm.close()


@pytest.mark.parametrize("poisson", [False, True])
@pytest.mark.parametrize("suffix", [".tsv.gz", ".tsv"])
def test_inline_bytes_equal_jax(tmp_path, calibrators, poisson, suffix):
    chunks = _chunks(np.random.default_rng(4))
    j_cal, t_cal = calibrators
    n_j = _run(jfarm, tmp_path / f"j{suffix}", chunks, calibrator=j_cal,
               poisson=poisson)
    n_t = _run(post_farm, tmp_path / f"t{suffix}", chunks,
               calibrator=t_cal, poisson=poisson)
    assert n_t == n_j == sum(len(c[1]) for c in chunks)
    got = (tmp_path / f"t{suffix}").read_bytes()
    assert got == (tmp_path / f"j{suffix}").read_bytes()
    text = gzip.decompress(got) if suffix.endswith(".gz") else got
    lines = text.decode().splitlines()
    assert lines[0].split("\t") == HEADER and len(lines) == n_t + 1


def test_workers_bytes_equal_inline(tmp_path, calibrators):
    chunks = _chunks(np.random.default_rng(5))
    cal = calibrators[1]
    n0 = _run(post_farm, tmp_path / "inline.tsv.gz", chunks, calibrator=cal,
              n_workers=0)
    n2 = _run(post_farm, tmp_path / "workers.tsv.gz", chunks,
              calibrator=cal, n_workers=2)
    assert n0 == n2
    assert ((tmp_path / "inline.tsv.gz").read_bytes()
            == (tmp_path / "workers.tsv.gz").read_bytes())


def test_worker_error_and_dead_workers_raise(tmp_path, calibrators,
                                             monkeypatch):
    monkeypatch.setattr(post_farm, "POLL_S", 0.2)
    chunks = _chunks(np.random.default_rng(6))
    # a chunk whose logits the 4-class calibrator cannot take
    bad = chunks[1][:3] + (np.zeros((1, 3), np.float32),)
    farm = post_farm.PostprocessFarm(str(tmp_path / "e.tsv.gz"), HEADER,
                                     calibrator=calibrators[1], n_workers=2)
    farm.submit(*chunks[0])
    farm.submit(*bad)
    with pytest.raises(RuntimeError, match="postprocess worker failed: "
                       "ValueError"):
        farm.close()
    assert not any(p.is_alive() for p in farm._procs)

    # workers killed by the OS: close gives up, and so does a submit
    # that finds the bounded queue full
    for submits, stage in ((2, "close"), (6, "submit")):
        farm = post_farm.PostprocessFarm(str(tmp_path / "d.tsv.gz"),
                                         HEADER, n_workers=2)
        for p in farm._procs:
            p.kill()
            p.join(timeout=30)
        with pytest.raises(RuntimeError, match="died"):
            for chunk in (chunks * 2)[:submits]:
                farm.submit(*chunk)
            assert stage == "close"
            farm.close()
        if stage == "submit":
            farm.abort()


def test_auto_n_workers_is_the_jax_policy():
    got = [post_farm.auto_n_workers(c) for c in range(1, 17)]
    assert got == [jfarm.auto_n_workers(c) for c in range(1, 17)]
    assert got[:3] == [0, 0, 1] and got[-1] == 6
    assert post_farm.auto_n_workers() == jfarm.auto_n_workers()

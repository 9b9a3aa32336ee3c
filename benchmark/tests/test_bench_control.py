"""The controls, on the card: the plain reference put in the program's
place in the next precision below float32 (TF32) fails a number of each
cell's comparison, at the cell's widths on a smaller data set.  These
need the CUDA card and skip without it; the readings the limits were set
from are in PERF.md (``tools/train_gaps.py``, ``tools/genome_gaps.py``
at a dozen seeds and more)."""

import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from runners import genome as gdrv
from runners import train as tdrv
from harness import spec
from reference import calib as rcal
from reference import data as rdata

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.chip
@pytest.mark.parametrize("name", ["snv_hs.train", "indel_hs.train"])
def test_train_control_fails(card, name):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.load_cell(ROOT, name)
    cfg = cell.config
    cfg["train_genome_bases"] = 40 * (2 * cfg["distal_radius"] + 1)
    cfg["train_sites"] = 4000
    failed = []
    for seed in (31, 32, 33):
        setup = tdrv.Setup(cell, seed, card)
        control = tdrv.control_first_steps(setup, tf32=True)
        got = tdrv.readings(setup, control,
                            tdrv.reference_steps(setup, control))
        failed.append(any(got[k] > v for k, v in cell.limits.items()
                          if k in got))
    assert all(failed)


@pytest.mark.chip
@pytest.mark.parametrize("name", ["snv_hs.train", "indel_hs.train"])
def test_group_control_fails(card, name):
    """The control in the program's place for the group that a run reads
    after its window, here after 2 s of the program's steps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.load_cell(ROOT, name)
    cfg = cell.config
    cfg["train_genome_bases"] = 400 * (2 * cfg["distal_radius"] + 1)
    cfg["train_sites"] = 40000
    failed = []
    for seed in (31, 32, 33):
        setup = tdrv.Setup(cell, seed, card)
        tdrv.program_first_steps(setup)
        s = tdrv.warm_up(setup, tdrv.CHECK_STEPS)
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < 2.0
               and s + 2 * setup.k <= setup.n_steps):
            setup.run(s, s + setup.k)
            s += setup.k
        group = tdrv.program_group(setup, s)
        setup.groups = None
        got = tdrv.group_readings(tdrv.control_group(setup, group),
                                  tdrv.reference_group(setup, group))
        failed.append(any(got[k] > v for k, v in cell.limits.items()
                          if k in got))
    assert all(failed)


@pytest.mark.chip
@pytest.mark.parametrize("name", ["snv_hs.genome", "indel_hs.genome"])
def test_genome_control_fails(card, name):
    cell = spec.load_cell(ROOT, name)
    limit = cell.limits["prob_gap"]
    for seed in (31, 32, 33):
        with tempfile.TemporaryDirectory() as work:
            inputs = gdrv.Inputs(cell, seed, card, Path(work), 400_000)
            pos, neg = rdata.focal_sites(inputs.codes,
                                         cell.config["focal_base"])
            rows = np.sort(np.random.default_rng(seed).choice(
                len(pos), cell.traffic["check_sites"], replace=False))
            exact = gdrv.reference_probs(inputs, pos[rows], neg[rows], card)
            control = gdrv.reference_probs(inputs, pos[rows], neg[rows],
                                           card, torch.float32, tf32=True)
            gap = rcal.excess_gap(rcal.as_written(control), exact,
                                  cell.config["poisson"])
            assert gap > limit, (seed, gap)

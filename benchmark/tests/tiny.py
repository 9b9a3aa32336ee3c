"""Tiny cells for CPU tests: the benchmark's configurations and traffic
mixes with the scale and widths cut so that a run takes seconds."""

import copy
from pathlib import Path

from harness import spec

ROOT = Path(__file__).resolve().parents[2]


def cell(name: str, **traffic):
    c = copy.deepcopy(spec.load_cell(ROOT, name))
    cfg = c.config
    if cfg["model_type"] == "snv":
        cfg.update(distal_radius=100, CNN_out_channels=8,
                   local_hidden1_size=16, local_hidden2_size=8,
                   train_sites=3000, train_genome_bases=100000,
                   map_bases_per_s=20000, batch_size=8)
    else:
        cfg.update(distal_radius=32, down_list=[1, 2, 2, 2, 2, 2],
                   CNN_out_channels=2, train_sites=2000,
                   train_genome_bases=60000, map_bases_per_s=3000,
                   batch_size=8)
    c.traffic.update(batch_size=128, flush_batches=4, warm_sites=1024,
                     check_sites=200, n_workers=0, window_chunk_groups=1,
                     spare_seconds=20)
    if c.traffic["runner"] == "train":
        c.traffic["steps_per_dispatch"] = 2
    c.traffic.update(traffic)
    return c

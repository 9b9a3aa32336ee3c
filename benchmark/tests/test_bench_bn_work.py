"""The train-mode BatchNorm work of ``harness/bn_work.py`` and the reader
of ``k5_roofline_pct``, on the CPU: the counts equal the elements that
the program's models hand their BatchNorms of 3-D activations in a
train forward, and the reader reads K5's kernels alone."""

from pathlib import Path

import pytest
import torch

from harness import bn_work, flops, spec
from harness.outcome import Outcome
from harness.trace import Stretch

ROOT = Path(__file__).resolve().parents[2]


def _cell(name):
    return spec.load_cell(ROOT, name)


def test_counts_at_the_published_recipes():
    indel, snv = _cell("indel_hs.train"), _cell("snv_hs.train")
    assert bn_work.elements_per_window(indel.config, indel.traffic) == 999_936
    assert bn_work.elements_per_window(snv.config, snv.traffic) == 33_088
    # without the fused stem, the stems' BatchNorms on the one-hot too
    assert bn_work.elements_per_window(
        snv.config, {"fused_stem": "off"}) == 33_088 + 4 * (2001 + 201)
    # 5 float32 passes an element: 0.764 ms a U-Net step at 3.35 TB/s
    assert bn_work.train_bytes(indel.config, indel.traffic, 128) \
        == 20 * 128 * 999_936


@pytest.mark.parametrize("name,fused", [("indel_hs.train", False),
                                        ("snv_hs.train", True),
                                        ("snv_hs.train", False)])
def test_counts_follow_the_program(name, fused):
    """The elements that reach the program's BatchNorms of 3-D
    activations in one train forward, per window."""
    from mural_tpu_torch.models.registry import build_model
    cfg = _cell(name).config
    snv = cfg["model_type"] == "snv"
    n_cat = 2 * cfg["local_radius"] + 1 - cfg["local_order"] + 1 if snv \
        else 1
    common = {"emb_dims": [(4 ** cfg["local_order"] + 1, 2)] * n_cat,
              "n_cont": 0, "n_class": cfg["n_class"], "in_channels": 4}
    model = build_model(cfg["model_no"], cfg, common, cfg["model_type"])
    seen = []
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.register_forward_hook(
                lambda mod, args, out: seen.append(
                    args[0].shape[1] * args[0].shape[2])
                if args[0].dim() == 3 else None)
    B, W = 2, 2 * cfg["distal_radius"] + snv
    codes = torch.randint(0, 4, (B, W), dtype=torch.uint8)
    distal = codes if fused else torch.eye(4)[codes.long()]
    cat = torch.zeros((B, n_cat), dtype=torch.long)
    model.train()
    with torch.no_grad():
        model(cat, distal)
    traffic = {"fused_stem": "on" if fused else "off"}
    assert sum(seen) == bn_work.elements_per_window(cfg, traffic)


def _stretch(names, units=4):
    return Stretch(events=[(n, 10.0 * i, 100.0) for i, n in
                           enumerate(names)], host=[], start_us=0.0,
                   seconds=0.01, units=units)


def _outcome(stretch):
    return Outcome(0, 0, {}, 0, 0, [], 0, stretch,
                   {"kind": "train", "batch": 128})


def test_reader_reads_k5_alone():
    reader = spec.load_module("metrics", "k5_roofline_pct")
    cell = _cell("indel_hs.train")
    k5 = ["void (anonymous namespace)::k5_bn_stats_kernel<float, 4>(...)",
          "void (anonymous namespace)::k5_bn_apply_kernel<float, 4>(...)",
          "void (anonymous namespace)::k5_bn_bwd_reduce_kernel<float, 1>()",
          "void (anonymous namespace)::k5_bn_bwd_apply_kernel<float, 1>()"]
    cudnn = ["void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float>()",
             "void cudnn::bn_bw_1C11_kernel_new<float, float>()"]
    got = reader.read(_outcome(_stretch(k5 + cudnn)), cell)
    least, _ = flops.least_seconds(
        bn_work.train_bytes(cell.config, cell.traffic, 128) * 4, 0)
    assert got == pytest.approx(100 * least / 400e-6)
    # the parent's program: cuDNN's BatchNorm only, nothing to read
    assert reader.read(_outcome(_stretch(cudnn)), cell) is None
    assert reader.read(_outcome(_stretch(k5, units=0)), cell) is None
    assert reader.read(_outcome(None), cell) is None

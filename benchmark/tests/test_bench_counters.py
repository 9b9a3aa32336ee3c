"""The FLOP and byte counters against hand counts at small shapes."""

import pytest

from harness import flops


def test_pool_and_conv_lengths():
    assert flops.pool_len(2001, 15, 15, 7) == 134
    assert flops.pool_len(134, 7, 7, 3) == 20
    assert flops.pool_len(20, 3, 3, 1) == 7
    assert flops.conv_len(8000, 7, 4) == 2000
    assert flops.conv_len(16, 7, 2) == 8


def test_snv2_forward_by_hand():
    cfg = {"reference": "snv2", "CNN_kernel_size": 3, "CNN_out_channels": 2,
           "local_hidden1_size": 3, "local_hidden2_size": 2, "n_class": 2,
           "local_radius": 2, "local_order": 3, "distal_radius": 100}
    # local: 3 k-mers x 5 -> 3 -> 2 -> 2
    local = 2 * (15 * 3 + 3 * 2 + 2 * 2)
    # tower 1 on 201: stem 4->2 k3 at 201; pools 3 -> 67 -> 23 -> 8
    t1 = 2 * (4 * 2 * 3 * 201 + 4 * 2 * 2 * 3 * 67
              + 5 * 2 * 2 * 3 * 23 + 2 * 2 * 3 * 8 + 2 * 2)
    # tower 2 on 201: pools 15/7 -> 14, 7/3 -> 2, 3/1 -> 1
    t2 = 2 * (4 * 2 * 3 * 201 + 4 * 2 * 2 * 3 * 14
              + 5 * 2 * 2 * 3 * 2 + 2 * 2 * 3 * 1 + 2 * 2)
    assert flops.forward_flops(cfg) == local + t1 + t2


def test_train_counts_data_gradients_where_needed():
    cfg = {"reference": "snv2", "CNN_kernel_size": 3, "CNN_out_channels": 2,
           "local_hidden1_size": 3, "local_hidden2_size": 2, "n_class": 2,
           "local_radius": 2, "local_order": 3, "distal_radius": 100}
    stems = 2 * (2 * 4 * 2 * 3 * 201)        # two stems, no data gradient
    assert flops.train_flops(cfg) == 3 * flops.forward_flops(cfg) - stems


def test_unet_forward_by_hand():
    cfg = {"reference": "unet", "CNN_kernel_size": 3, "CNN_out_channels": 1,
           "down_list": [1, 2, 2, 2, 2, 2], "distal_radius": 32,
           "n_class": 2, "use_reverse": False}
    lens = [64, 32, 16, 8, 4, 2]
    ch = [1, 2, 3, 4, 5, 6]
    want = 0
    c_in = 4
    for c, L in zip(ch, lens):
        want += 2 * (c_in * c * 3 * L + c * 2 * c * 5 * L + 2 * c * c * L)
        c_in = c
    for lv in range(4, -1, -1):
        c, L = ch[lv], lens[lv]
        want += 2 * (ch[lv + 1] * c * 3 * L + c * 2 * c * 5 * L
                     + 2 * c * c * L)
    want += 2 * (2 * 1 * 1 * 64) + 2 * 1 * 2
    assert flops.forward_flops(cfg) == want


def test_kernel_work_by_hand():
    cfg = {"CNN_kernel_size": 3, "CNN_out_channels": 2, "distal_radius": 100}
    B = 4
    # K1: tower 2 and the crop are both 201 long here
    n_bytes, n_ops = flops.k1_work(cfg, B)
    per = B * 201 + B * 201 * 2 * 4 + (3 * 16 * 2 + 2) * 4
    assert n_bytes == 2 * per and n_ops == 2 * B * 201 * 2 * 3
    # K2: pooled (B, C, P) f32 + u8 argmax out
    b2, o2 = flops.k2_work(cfg, B)
    P2, P1 = 14, 67
    assert b2 == (B * 201 + B * 2 * P2 * 5 + 392) + (B * 201 + B * 2 * P1 * 5
                                                     + 392)
    # conv positions inside the pool windows, min(L + pp, P * pk) - pp:
    # 201 of tower 2's (P * pk = 210), 200 of the crop's (P * pk = 201)
    assert o2 == B * 2 * 4 * (201 + 200)
    b3, o3 = flops.k3_work(cfg, B)
    assert o3 == B * 2 * 3 * (P2 + P1)
    assert b3 == 2 * B * 201 + B * 2 * (P2 + P1) * 5 + 2 * 3 * 16 * 2 * 4


def test_least_seconds_names_the_bound():
    t, by = flops.least_seconds(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = flops.least_seconds(1.0, 67e12)
    assert t == pytest.approx(1.0) and by == "operations"

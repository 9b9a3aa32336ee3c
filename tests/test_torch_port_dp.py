"""Data-parallel training of the port (``--dp_devices``) on two gloo ranks
on the CPU: the cross-rank BatchNorm against ``nn.BatchNorm1d`` on the
whole batch, the fused stem's histogram reduced over the ranks, one
2-rank train step against the 1-rank step (SNVNet2 unfused and with the
fused stem's plain versions, the INDEL U-Net), a 1-epoch data-parallel
``train_trial`` against the JAX package's on the virtual devices, and
the JAX package's error for a batch that does not split.  Every dropout
is 0: each rank draws its own shard's masks.

The ranks are spawned processes: the functions they run live at the top
of this module, which imports nothing of JAX at import time."""
import numpy as np
import pytest
import torch

from mural_tpu_torch.parallel.distributed import spawn_ranks
from mural_tpu_torch.parallel.sync_bn import (CrossRankBatchNorm,
                                              convert_batchnorm)

B = 16                   # global batch of the checks
BN_TOL = 1e-6            # cross-rank BN against BN on the whole batch
STEP_TOL = 1e-5          # 2-rank step against the 1-rank step
# small widths, dropout 0: the model's fields of
# test_torch_port_train.CONFIG, copied because that module imports JAX
# and the spawned ranks import this one
SNV_CONFIG = dict(
    segment_center=4000, distal_radius=200, CNN_kernel_size=3,
    CNN_out_channels=8, local_radius=3, local_order=2,
    local_hidden1_size=30, local_hidden2_size=10, emb_dropout=0.0,
    distal_fc_dropout=0.0, local_dropout=0.0)
INDEL_CONFIG = dict(
    local_radius=3, local_order=1, local_dropout=0.0,
    distal_fc_dropout=0.0, emb_dropout=0.0, local_hidden1_size=8,
    local_hidden2_size=4, distal_radius=100, segment_center=4000,
    CNN_kernel_size=7, CNN_out_channels=4, down_list=[1, 2, 2, 5, 5, 1],
    use_reverse=True)
# (model, fused stem, dtype, optimizer): SNVNet2 unfused and the U-Net
# with Adam in float64; SNVNet2 with the fused stem, whose plain K2/K3
# run float32 only, with SGD: a bias before a pool and a BN has a zero
# gradient but for float32 noise, which Adam's first step scales to the
# LR, on one rank's noise as on two ranks' (the JAX package's step tests
# hold Adam in float64 for this)
STEP_CASES = {"snv2": ("snv", False, torch.float64, "Adam"),
              "snv2_fused": ("snv", True, torch.float32, "SGD"),
              "indel": ("indel", False, torch.float64, "Adam")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch here, and so one in each rank (the
    ranks split the caller's threads): the suite runs one process per
    core (as tests/test_torch_port_indel_model.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bn_inputs(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0.5, 2.0, size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=shape[1]).astype(np.float32)
    b = rng.normal(size=shape[1]).astype(np.float32)
    return x, g, w, b


def _bn_run(bn, x, g, w, b):
    """Train-mode forward and backward: (out, dx, dweight, dbias,
    running_mean, running_var) as numpy."""
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = bn.train()(xt)
    out.backward(torch.from_numpy(g))
    return tuple(t.detach().numpy().copy() for t in (
        out, xt.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
        bn.running_var))


def _codes(seed, shape):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=shape).astype(np.uint8)
    codes[rng.random(shape) < 0.05] = 14
    codes[rng.random(shape) < 0.02] = rng.integers(4, 14)
    return codes


def _step_model(kind):
    """A seeded model of ``kind`` and one batch of B rows: (model,
    [y, cat, distal, mask] tensors, distal is the codes for the fused
    stem, else their one-hot)."""
    from mural_tpu_torch.models.init import init_weights
    from mural_tpu_torch.models.layers import one_hot_from_codes
    from mural_tpu_torch.models.registry import build_model
    model_type, fused, dtype, _ = STEP_CASES[kind]
    rng = np.random.default_rng(7)
    if model_type == "snv":
        n_cat, vocab, n_class, width = 7, 17, 4, 401
        model_no, config = 2, SNV_CONFIG
        common_emb = [(vocab, 2)] * n_cat
    else:
        n_cat, vocab, n_class, width = 6, 4, 8, 200
        model_no, config = 0, INDEL_CONFIG
        common_emb = [(vocab, 1)] * n_cat
    common = {"emb_dims": common_emb, "n_cont": 0, "n_class": n_class,
              "distal_order": 1, "in_channels": 4}
    model = init_weights(build_model(model_no, config, common, model_type),
                         torch.Generator().manual_seed(3)).to(dtype)
    if model_type == "indel":
        model.out_fc[1].p = 0.0
    codes = torch.from_numpy(_codes(5, (B, width)))
    distal = codes if fused else one_hot_from_codes(codes, dtype)
    batch = [torch.from_numpy(rng.integers(0, n_class, B)).long(),
             torch.from_numpy(rng.integers(0, vocab, (B, n_cat))).long(),
             distal, torch.ones(B, dtype=dtype)]
    return model, batch


def _steps(kind, ctx=None, n_steps=2):
    """``n_steps`` train steps of ``kind`` on the whole batch (``ctx``
    None) or on this rank's rows: (global losses, parameters and buffers
    after the steps)."""
    from mural_tpu_torch.train.optim import LRSchedule, build_optimizer
    from mural_tpu_torch.train.steps import TrainState, train_step
    model, batch = _step_model(kind)
    if ctx is not None:
        convert_batchnorm(model)
        batch = [t[ctx.shard(B)] for t in batch]
    state = TrainState(model, build_optimizer(STEP_CASES[kind][3],
                                              model.parameters(), 1e-5),
                       LRSchedule.build("StepLR", 1e-3, 0.9, B, 4 * B,
                                        1e-4, 1e-6))
    if ctx is not None:
        state.grad_reduce = ctx.reduce_grads
    losses = []
    for _ in range(n_steps):
        loss, _ = train_step(state, *batch)
        if ctx is not None:
            ctx.all_reduce_(loss)
        losses.append(float(loss))
    return losses, {k: v.detach().numpy().copy()
                    for k, v in model.state_dict().items()}


def _rank_checks(ctx):
    """Every check's result on one rank."""
    from mural_tpu_torch.ops.fused_train_stem import hist_batch_stats
    rows = ctx.shard(B)
    bn = {}
    for shape in ((B, 3, 5), (B, 6)):
        x, g, w, b = _bn_inputs(shape)
        bn[shape] = _bn_run(CrossRankBatchNorm(shape[1]), x[rows], g[rows],
                            w, b)
    codes = torch.from_numpy(_codes(9, (B, 401)))
    hist = [t.numpy() for t in hist_batch_stats(
        codes[rows], CrossRankBatchNorm.reduce_counts)]
    steps = {kind: _steps(kind, ctx) for kind in STEP_CASES}
    return {"bn": bn, "hist": hist, "steps": steps}


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(_rank_checks, ["cpu", "cpu"])


@pytest.mark.parametrize("shape", [(B, 3, 5), (B, 6)])
def test_cross_rank_batchnorm_matches_whole_batch(ranks, shape):
    """Outputs and input gradients of the two shards, the weight and bias
    gradients summed over the ranks (as the step reduces them), and the
    running statistics of each rank against ``nn.BatchNorm1d`` on the
    whole batch, within 1e-6 of each quantity's largest entry (float32:
    the sums of 80 terms differ in their last bits)."""
    want = _bn_run(torch.nn.BatchNorm1d(shape[1]), *_bn_inputs(shape))
    got = [r["bn"][shape] for r in ranks]

    def close(a, w):       # float32: within 1e-6 of the largest entry
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=BN_TOL * np.abs(w).max())

    for i in (0, 1):                       # out, dx: the shards in order
        close(np.concatenate([g[i] for g in got]), want[i])
    for i in (2, 3):                       # dweight, dbias: summed
        close(got[0][i] + got[1][i], want[i])
    for g in got:                          # running stats on each rank
        for i in (4, 5):
            close(g[i], want[i])


def test_cross_rank_batchnorm_keeps_state_dict():
    """The swap keeps keys, tensors (an optimizer built before holds
    them) and the eval forward; a module registered twice stays one."""
    bn = torch.nn.BatchNorm1d(4)
    model = torch.nn.Sequential(bn, torch.nn.Linear(4, 4), bn)
    keys = list(model.state_dict())
    weight = bn.weight
    convert_batchnorm(model)
    assert isinstance(model[0], CrossRankBatchNorm) and model[0] is model[2]
    assert list(model.state_dict()) == keys and model[0].weight is weight
    x = torch.randn(5, 4)
    assert torch.equal(model[0].eval()(x), bn.eval()(x))


def test_reduced_histogram_matches_whole_batch(ranks):
    """The fused stem's statistics from the histogram reduced over the
    ranks equal the whole batch's, exactly."""
    from mural_tpu_torch.ops.fused_train_stem import hist_batch_stats
    want = hist_batch_stats(torch.from_numpy(_codes(9, (B, 401))))
    for r in ranks:
        for got, w in zip(r["hist"], want):
            np.testing.assert_array_equal(got, w.numpy())


@pytest.mark.parametrize("kind", list(STEP_CASES))
def test_two_rank_steps_match_one_rank(ranks, kind):
    """Two steps on two ranks (each its 8 rows, cross-rank BN, gradients
    summed before the clip) against the same steps on the whole batch:
    global loss and every parameter and buffer within 1e-5, equal on both
    ranks."""
    want_losses, want_state = _steps(kind)
    for r in ranks:
        losses, state = r["steps"][kind]
        np.testing.assert_allclose(losses, want_losses, rtol=STEP_TOL)
        assert list(state) == list(want_state)
        for k, v in state.items():
            np.testing.assert_allclose(v, want_state[k], rtol=0,
                                       atol=STEP_TOL, err_msg=k)
    for k, v in ranks[0]["steps"][kind][1].items():
        np.testing.assert_array_equal(v, ranks[1]["steps"][kind][1][k])


def test_batch_must_split_over_ranks(tmp_path):
    """The JAX package's error, before any rank starts."""
    from mural_tpu_torch.train.loop import TrainOptions, train_trial
    with pytest.raises(ValueError, match="batch_size 30 must be divisible "
                       "by dp_devices 4"):
        train_trial({"batch_size": 30}, TrainOptions(
            train_data="sites.bed", ref_genome="seq.fa", device="cpu",
            dp_devices=4, trial_dir=str(tmp_path)), "snv")


def test_dp_trial_matches_jax_dp_trial(tmp_path, monkeypatch):
    """One epoch of ``train_trial(dp_devices=2, device='cpu')`` (two
    spawned gloo ranks) against the JAX package's ``train_trial(
    dp_devices=2)`` on two of the 8 virtual devices, from the same
    initial weights (the port's seeded init, bridged into the JAX run):
    validation loss within rel 5e-3, the JAX package's DP bound
    (tests/test_parallel.py), and the same trial files."""
    import mural_tpu.train.loop as j_loop
    from mural_tpu.utils.torch_import import flax_from_torch
    from mural_tpu_torch.data.dataset import prepare_dataset
    from mural_tpu_torch.models.registry import build_model
    from mural_tpu_torch.train import loop
    from test_torch_port_train import CONFIG
    from test_torch_port_train_trial import _trial_files, _write_data
    fasta, bed = _write_data(tmp_path, np.random.default_rng(3))
    config = dict(CONFIG, learning_rate=1e-4)
    ds = prepare_dataset(bed, fasta, central_bp=config["segment_center"],
                         local_radius=config["local_radius"],
                         local_order=config["local_order"],
                         distal_radius=config["distal_radius"])
    common = {"emb_dims": [(x, min(16, int(x ** 0.25)))
                           for x in ds.cat_dims],
              "n_cont": 0, "n_class": 4, "distal_order": 1,
              "in_channels": 4}
    init = loop.init_model(build_model(2, config, common, "snv"), ds, 1)
    sd = {k: v.numpy() for k, v in init.state_dict().items()}
    j_init = j_loop._init_variables
    monkeypatch.setattr(j_loop, "_init_variables", lambda model, d, seed:
                        flax_from_torch(sd, j_init(model, d, seed)))
    common = dict(train_data=bed, ref_genome=fasta, epochs=1,
                  valid_ratio=0.5, split_seed=0, rng_seed=1, dp_devices=2)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm = j_loop.train_trial(dict(config), j_loop.TrainOptions(
        trial_dir=jdir, resident="off", steps_per_dispatch=1, **common),
        "snv")
    tm = loop.train_trial(dict(config), loop.TrainOptions(
        trial_dir=tdir, device="cpu", **common), "snv")
    assert tm["loss"] == pytest.approx(jm["loss"], rel=5e-3)
    assert tm["total_params"] == jm["total_params"]
    assert _trial_files(tdir) == _trial_files(jdir)

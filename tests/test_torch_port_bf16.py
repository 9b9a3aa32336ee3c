"""``--bf16`` in the port on the CPU: the single-pass bf16 mode of the
stem kernels K2/K3 (their plain versions here) against the JAX
package's ``code_conv_pool(..., split=False)`` in interpret mode and
against the unfused torch composition under autocast; bf16 train steps
against the JAX package's ``make_packed_train_step(..., bf16=True)``;
the dtypes that stay float32; K-step groups; the CLI."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mural_tpu.train.loop as j_loop
from mural_tpu.models.registry import build_model as j_build_model
from mural_tpu.ops import fused_train_stem as jfts
from mural_tpu.train import optim as j_optim
from mural_tpu.train.packed import make_packed_train_step, pack_state
from mural_tpu.train.state import create_train_state
from mural_tpu_torch.models import layers
from mural_tpu_torch.models.init import init_weights
from mural_tpu_torch.models.registry import build_model
from mural_tpu_torch.ops.fused_train_stem import (
    code_conv_pool, code_conv_pool_backward_reference,
    code_conv_pool_reference, pool_out_len)
from mural_tpu_torch.train.graphs import StepGroups, epoch_scalars
from mural_tpu_torch.train.optim import (GraphOptimizer, LRSchedule,
                                         build_optimizer)
from mural_tpu_torch.train.steps import TrainState, model_input, train_step
from mural_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_indel_model import one_torch_thread  # noqa: F401
from test_torch_port_train import CONFIG, _rel

BF16_ULP = 2.0 ** -8        # bfloat16's spacing relative to a value's scale
# (k, C, L, pk, pp, B): both towers' pools, k 3 and 5, C 32 and 30
KERNEL_CASES = [(3, 32, 401, 15, 7, 5), (3, 30, 201, 3, 1, 8),
                (5, 32, 201, 3, 1, 1), (5, 30, 401, 15, 7, 3)]


def _stem_inputs(rng, k, C, L, B):
    """Codes over all 16 values (N is 14, the sentinel 15), a table with
    a zero sentinel row, a bias."""
    codes = rng.integers(0, 16, size=(B, L)).astype(np.uint8)
    codes[0, :7] = 14
    table = rng.normal(size=(k, 16, C)).astype(np.float32)
    table[:, 15] = 0.0
    return codes, table, rng.normal(size=C).astype(np.float32)


def _jax_split_false(codes, table, bias, pk, pp):
    """The JAX single-pass mode in interpret mode: (pooled f32 (B, P, C),
    jstar (B, P, C)), through the op's own window codes and table
    placement."""
    B, L = codes.shape
    k, _, C = table.shape
    P = jfts.pool_out_len(L, pk, pp)
    T = pk + k - 1
    Kp = jfts._round_up(T * 16, 128)
    Np = jfts._round_up(pk * C, 128)
    wc = jfts._window_codes(jnp.asarray(codes), k, pk, pp, P)
    M = B * P
    mt = min(jfts._M_TILE, jfts._round_up(M, 16))
    Mp = jfts._round_up(M, mt)
    wc = jnp.pad(wc, ((0, Mp - M), (0, 0)), constant_values=15)
    u = jfts.build_u(jnp.asarray(table), pk, Kp, Np)
    pooled, jstar = jfts._win_pool_fwd_impl(wc, u, k, pk, C, P, L, pp,
                                            False, True)
    pooled = np.asarray(pooled[:M]).reshape(B, P, C) + bias
    return pooled, np.asarray(jstar[:M]).reshape(B, P, C)


@pytest.mark.parametrize("k,C,L,pk,pp,B", KERNEL_CASES)
def test_k2_bf16_mode_matches_jax_split_false(k, C, L, pk, pp, B):
    """The plain K2 in bf16 mode against JAX's ``split=False`` Pallas
    kernel (interpret mode): the same first-max ``jstar``; the float32
    value before the cast within 1e-6 (the same bf16 table entries summed
    in float32, the taps in another order); after the cast equal, except
    where the two float32 values round to neighbouring bfloat16 numbers
    (at most 1% of the outputs, one bfloat16 step apart)."""
    codes, table, bias = _stem_inputs(np.random.default_rng(k * C + L),
                                      k, C, L, B)
    want, want_j = _jax_split_false(codes, table, bias, pk, pp)
    t, b = torch.from_numpy(table), torch.from_numpy(bias)
    c = torch.from_numpy(codes)
    f32, jstar = code_conv_pool_reference(c, t.bfloat16().float(), b, pk,
                                          pp)
    out, jstar16 = code_conv_pool_reference(c, t, b, pk, pp, bf16=True)
    assert out.dtype == torch.bfloat16 and jstar.dtype == torch.uint8
    np.testing.assert_array_equal(jstar16.numpy(), jstar.numpy())
    np.testing.assert_array_equal(jstar.numpy().transpose(0, 2, 1), want_j)
    np.testing.assert_allclose(f32.numpy().transpose(0, 2, 1), want,
                               rtol=0, atol=1e-6)
    want16 = torch.from_numpy(want).bfloat16().float().numpy()
    got16 = out.float().numpy().transpose(0, 2, 1)
    differ = got16 != want16
    assert differ.mean() <= 0.01
    step = BF16_ULP * np.abs(want[differ]) * 2
    assert (np.abs(got16 - want16)[differ] <= step).all()


@pytest.mark.parametrize("k,C,L,pk,pp,B", KERNEL_CASES)
def test_k3_bf16_mode_matches_jax_split_false(k, C, L, pk, pp, B):
    """The table and bias gradients of the bf16 mode against JAX's
    ``split=False`` VJP of the layer's bf16 output (g rounded to
    bfloat16 in both), within 1e-5 relative to the largest entry; the
    plain K3 alone, from the forward's jstar, the same."""
    rng = np.random.default_rng(3 * k + L)
    codes, table, bias = _stem_inputs(rng, k, C, L, B)
    P = pool_out_len(L, pk, pp)
    w = rng.normal(size=(B, P, C)).astype(np.float32)

    def loss(t, b):
        out = jfts.code_conv_pool(jnp.asarray(codes), t, b, pk, pp,
                                  interpret=True, split=False)
        return jnp.sum(out.astype(jnp.bfloat16).astype(jnp.float32) * w)

    want_t, want_b = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table),
                                                    jnp.asarray(bias))
    t = torch.from_numpy(table).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    c = torch.from_numpy(codes)
    out = code_conv_pool(c, t, b, pk, pp, bf16=True)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w).permute(0, 2, 1)).sum().backward()
    for got, want in ((t.grad, want_t), (b.grad, want_b)):
        assert got.dtype == torch.float32
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    _, jstar = code_conv_pool_reference(c, torch.from_numpy(table),
                                        torch.from_numpy(bias), pk, pp,
                                        bf16=True)
    g = torch.from_numpy(w).permute(0, 2, 1).contiguous()
    dtable = code_conv_pool_backward_reference(c, jstar, g, k, pk, pp,
                                               bf16=True)
    np.testing.assert_allclose(dtable.numpy(), np.asarray(want_t), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want_t)).max())


@pytest.mark.parametrize("pool", [(15, 15, 7), (3, 3, 1)])
def test_fused_stem_bf16_matches_unfused_autocast(pool):
    """The fused stem under a bf16 autocast (K2/K3's bf16 mode) against
    the unfused BN -> conv -> pool under the same autocast: outputs
    within 4 bfloat16 steps of the output scale (the unfused path rounds
    the BN output and the weight, the fused one the folded table).  Each
    bf16 path moves the pool's argmax where rounding decides a near tie,
    which moves a weight gradient by up to 20% of its largest entry (on
    these inputs); so each BN and conv gradient of the fused path is held
    to the float32 gradient as closely as the unfused path's is, within
    1.5 times its distance plus 1e-3 of the largest entry."""
    import copy
    torch.manual_seed(0)
    conv1 = layers.BNConv(4, 32, 3)
    with torch.no_grad():
        conv1[0].weight.uniform_(0.5, 1.5)
        conv1[0].bias.normal_(0, 0.2)
    codes = torch.randint(0, 15, (8, 401), dtype=torch.uint8)
    w = torch.randn(8, 32, pool_out_len(401, pool[0], pool[2]))
    outs, grads = {}, {}
    for fused in (True, False):
        for bf16 in (True, False):
            net = copy.deepcopy(conv1).train()
            with torch.autocast("cpu", dtype=torch.bfloat16, enabled=bf16):
                if fused:
                    out = layers.fused_stem_pool(net, codes, pool)
                else:
                    x = layers.one_hot_from_codes(codes).transpose(1, 2)
                    out = torch.nn.functional.max_pool1d(net(x), *pool)
            assert out.dtype == (torch.bfloat16 if bf16 else torch.float32)
            (out.float() * w).sum().backward()
            outs[fused, bf16] = out.float()
            grads[fused, bf16] = [p.grad for p in net.parameters()]
    ref = outs[False, True]
    assert ((outs[True, True] - ref).abs().max()
            <= 4 * BF16_ULP * ref.abs().max())
    for fused, unfused, f32 in zip(grads[True, True], grads[False, True],
                                   grads[False, False]):
        assert fused.dtype == torch.float32
        scale = f32.abs().max()
        err_fused = (fused - f32).abs().max() / scale
        err_unfused = (unfused - f32).abs().max() / scale
        assert err_fused <= 1.5 * err_unfused + 1e-3


def test_fold_under_autocast_is_the_float32_fold(monkeypatch):
    """``fused_stem_pool`` folds the table in float32 under a bf16
    autocast, bit-equal to the fold without autocast, and asks the
    kernels for the bf16 mode only under the autocast."""
    seen = []

    def record(codes, table, bias, pk, pp, bf16=False):
        seen.append((table.detach().clone(), bias.detach().clone(), bf16))
        return code_conv_pool(codes, table, bias, pk, pp, bf16)

    monkeypatch.setattr(layers, "code_conv_pool", record)
    torch.manual_seed(1)
    conv1 = layers.BNConv(4, 8, 3).eval()
    codes = torch.randint(0, 15, (4, 401), dtype=torch.uint8)
    layers.fused_stem_pool(conv1, codes, (15, 15, 7))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        layers.fused_stem_pool(conv1, codes, (15, 15, 7))
    (t32, b32, m32), (t16, b16, m16) = seen
    assert (m32, m16) == (False, True)
    assert t16.dtype == b16.dtype == torch.float32
    assert torch.equal(t16, t32) and torch.equal(b16, b32)


def _common(n_cat):
    return {"emb_dims": [(17, 2)] * n_cat, "n_cont": 0, "n_class": 4,
            "distal_order": 1, "in_channels": 4}


def _port_losses(variables, n_cat, schedule_args, batches, fused, bf16):
    model = build_model(2, CONFIG, _common(n_cat), "snv")
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, variables), model), strict=True)
    state = TrainState(model, build_optimizer("Adam", model.parameters(),
                                              1e-5),
                       LRSchedule.build(*schedule_args), bf16=bf16)
    out = []
    for y, cat, codes in batches:
        distal = model_input(torch.from_numpy(codes), fused)
        loss, _ = train_step(state, torch.from_numpy(y).long(),
                             torch.from_numpy(cat).long(), distal,
                             torch.ones(len(y)))
        out.append(float(loss))
    return out, model


class _DS:
    cat = np.zeros((2, 7), np.int32)
    n_cont = 0
    distal_width = 401
    n_distal_tracks = 0


def _setup(n_steps, B=64, n_cat=7, seed=41):
    """JAX SNVNet2 at CONFIG's widths with its init, the schedule's
    arguments and ``n_steps`` seeded batches."""
    rng = np.random.default_rng(seed)
    jmodel = j_build_model(2, CONFIG, _common(n_cat), "snv")
    variables = j_loop._init_variables(jmodel, _DS(), 8)
    schedule_args = ("StepLR", 2e-3, 0.9, B, 8 * B * 4, 1e-4, 1e-6)
    batches = [(rng.integers(0, 4, size=B).astype(np.int32),
                rng.integers(0, 17, size=(B, n_cat)).astype(np.int32),
                rng.integers(0, 15, size=(B, 401)).astype(np.uint8))
               for _ in range(n_steps)]
    return jmodel, variables, schedule_args, batches


def _jax_losses(jmodel, variables, schedule_args, batches, fused, bf16):
    jstate = pack_state(create_train_state(
        jmodel, variables, "Adam", 1e-5,
        j_optim.LRSchedule.build(*schedule_args)))
    jstep = make_packed_train_step(jmodel, jstate, donate=False, bf16=bf16,
                                   fused_stem=fused)
    out = []
    for y, cat, codes in batches:
        jstate, jloss, _ = jstep(jstate, jnp.asarray(y), jnp.asarray(cat),
                                 None, jnp.asarray(codes),
                                 jnp.ones((len(y),), jnp.float32),
                                 jax.random.key(0))
        out.append(float(jloss))
    return np.asarray(out)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_bf16_steps_match_jax(fused):
    """Eight ``--bf16`` SNVNet2 steps (dropout 0, Adam) against the JAX
    package's packed bf16 step on the same weights and batches: losses
    within 2e-2 relative, the JAX package's own bf16 band
    (``tests/test_bf16.py``); the port's bf16 losses within the same band
    of its float32 losses; BN buffers and parameters float32 after.  The
    batch is that test's, 64: at 32 rows the JAX package's own bf16 steps
    leave its band (2.5% from its float32 steps on these inputs)."""
    jmodel, variables, schedule_args, batches = _setup(8)
    want = _jax_losses(jmodel, variables, schedule_args, batches, fused,
                       True)
    got, model = _port_losses(variables, 7, schedule_args, batches, fused,
                              True)
    f32, _ = _port_losses(variables, 7, schedule_args, batches, fused,
                          False)
    assert np.isfinite(got).all()
    for a, b, c in zip(got, want, f32):
        assert _rel(a, b) <= 2e-2 and _rel(a, c) <= 2e-2, (a, b, c)
    assert got[-1] < got[0]
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        want_dtype = torch.int64 if "num_batches" in name else torch.float32
        assert t.dtype == want_dtype, name


def test_bf16_drift_over_64_steps_as_jax():
    """64 fused steps: bf16 and float32 trajectories drift apart per step
    in both packages alike (chaotic amplification of the rounding; on
    these inputs the JAX package's bf16 steps leave its 2e-2 band of its
    float32 steps too), so the port's largest per-step drift is held to
    1.5 times the JAX package's plus 5e-3; the first 8 steps stay within
    2e-2 per step, and the mean loss of each window of 8 steps within
    2e-2 (``chip_smoke.py`` phase 15 holds the card to the same)."""
    jmodel, variables, schedule_args, batches = _setup(64)
    runs = {(pkg, bf16): (_jax_losses(jmodel, variables, schedule_args,
                                      batches, True, bf16) if pkg == "jax"
                          else np.asarray(_port_losses(
                              variables, 7, schedule_args, batches, True,
                              bf16)[0]))
            for pkg in ("jax", "port") for bf16 in (False, True)}
    drift = {pkg: np.abs(runs[pkg, True] / runs[pkg, False] - 1)
             for pkg in ("jax", "port")}
    windows = np.abs(runs["port", True].reshape(8, 8).mean(1)
                     / runs["port", False].reshape(8, 8).mean(1) - 1)
    print(f"bf16 drift from float32 over 64 steps: port {drift['port'].max()}"
          f", JAX {drift['jax'].max()}; port 8-step windows {windows}")
    assert drift["port"].max() <= 1.5 * drift["jax"].max() + 5e-3
    assert drift["port"][:8].max() <= 2e-2
    assert windows.max() <= 2e-2


def test_unet_bf16_gradients_reach_every_conv():
    """The U-Net's global max keeps its gradient under a bf16 autocast:
    every conv weight gets a non-zero float32 gradient (the JAX package's
    ``tests/test_bf16.py`` trap)."""
    config = dict(CNN_out_channels=4, CNN_kernel_size=3,
                  down_list=[1, 2, 2, 2, 2, 2], use_reverse=True)
    common = dict(emb_dims=[(17, 2)] * 9, n_cont=0, n_class=4,
                  distal_order=1, in_channels=4)
    model = init_weights(build_model(0, config, common, "indel"),
                         torch.Generator().manual_seed(0)).train()
    model.out_fc[1].p = 0.0
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 4, (4, 64)).astype(np.uint8))
    y = torch.from_numpy(rng.integers(0, 4, 4))
    state = TrainState(model, GraphOptimizer("Adam", model.parameters(), 0),
                       LRSchedule.build("StepLR", 1e-3, 0.9, 4, 400, 1e-4,
                                        1e-6), bf16=True)
    from mural_tpu_torch.train.steps import masked_ce_sum, mixed_precision
    with mixed_precision(y.device, state.bf16):
        logits = model(None, model_input(codes, False))
    assert logits.dtype == torch.bfloat16
    masked_ce_sum(logits, y, torch.ones(4)).backward()
    dead = [name for name, p in model.named_parameters()
            if p.dim() == 3 and float(p.grad.norm()) == 0.0]
    assert not dead, dead
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())


def test_bf16_groups_match_single_steps():
    """A group of 4 bf16 steps (``StepGroups``, GraphOptimizer, eager on
    the CPU) against 4 single bf16 steps of torch's Adam: the same
    losses and parameters."""
    n_cat = 7
    batches = [(torch.from_numpy(r.integers(0, 4, size=16)),
                torch.from_numpy(r.integers(0, 17, size=(16, n_cat))),
                torch.from_numpy(r.integers(0, 15, size=(16, 401))
                                 .astype(np.uint8)), torch.ones(16))
               for r in [np.random.default_rng(i) for i in range(4)]]
    sched = LRSchedule("StepLR", 1e-2, 0.5, 2, 2e-3, 1.5e-3, 10)
    runs = []
    for grouped in (True, False):
        model = init_weights(build_model(2, CONFIG, _common(n_cat), "snv"),
                             torch.Generator().manual_seed(5))
        state = TrainState(model, (GraphOptimizer if grouped else
                                   build_optimizer)(
            "Adam", model.parameters(), 1e-2), sched, bf16=True)
        if grouped:
            def batch(inputs, i):
                y, cat, codes, mask = (t[i] for t in inputs)
                return y, cat, model_input(codes, True), mask, None

            inputs = tuple(torch.stack(t) for t in zip(*batches))
            losses = StepGroups(state, 4, batch).run(
                torch.from_numpy(epoch_scalars(state, 4)), inputs).tolist()
        else:
            losses = [float(train_step(state, y, cat, model_input(c, True),
                                       m)[0]) for y, cat, c, m in batches]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    (got, got_p), (want, want_p) = runs
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-6 * abs(b)
    for a, b in zip(got_p, want_p):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


@pytest.fixture(scope="module")
def snv_data(tmp_path_factory):
    from test_torch_port_tracks import write_genome
    base = tmp_path_factory.mktemp("port_bf16_cli")
    return write_genome(base, np.random.default_rng(4), {"chr1": 20_000},
                        150)


def _checkpoint_files(trial, epoch):
    ck = trial / f"checkpoint_{epoch}"
    return sorted(os.listdir(ck))


def test_cli_train_bf16_fused_writes_float32_triple(snv_data, tmp_path,
                                                    monkeypatch):
    """``mural_snv train --bf16 --fused_stem on`` on the CPU: the triple
    with float32 tensors, finite metrics and the mixed-precision line."""
    from mural_tpu_torch.cli.mural_snv import main as port_cli
    fasta, bed = snv_data
    monkeypatch.chdir(tmp_path)
    assert port_cli([
        "train", "--ref_genome", fasta, "--train_data", bed,
        "--experiment_name", "b", "--n_trials", "1", "--epochs", "1",
        "--cpu_only", "--batch_size", "32", "--CNN_out_channels", "8",
        "--local_hidden1_size", "30", "--local_hidden2_size", "10",
        "--valid_ratio", "0.2", "--split_seed", "0", "--segment_center",
        "2000", "--fused_stem", "on", "--bf16"]) == 0
    trial = next((tmp_path / "results" / "b").glob("Train_*"))
    assert _checkpoint_files(trial, 0) == [
        "epoch_0_metrics.txt", "model", "model.config.pkl",
        "model.fdiri_cal.pkl"]
    log = (trial / "training.log").read_text()
    assert "mixed precision: bfloat16" in log and "fused train stem" in log
    sd = torch.load(trial / "checkpoint_0" / "model")
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())
    metrics = (trial / "checkpoint_0" / "epoch_0_metrics.txt").read_text()
    loss = float(metrics.splitlines()[0].split(":")[1])
    assert np.isfinite(loss)


# the run flags of train and transfer, and train's small widths
RUN = ["--batch_size", "32", "--valid_ratio", "0.2", "--split_seed", "0",
       "--segment_center", "2000", "--n_trials", "1", "--epochs", "1",
       "--cpu_only"]
WIDTHS = ["--CNN_out_channels", "8", "--local_hidden1_size", "30",
          "--local_hidden2_size", "10"]


@pytest.mark.parametrize("extra", [
    ["--resident_data", "off", "--steps_per_dispatch", "1", "--fused_stem",
     "on"],
    ["--resident_data", "off", "--steps_per_dispatch", "4", "--fused_stem",
     "on"],
    ["--steps_per_dispatch", "1"],
    ["--model_no", "0"],
    ["--model_no", "1", "--fused_stem", "on"],
    ["--model_no", "3", "--bw_paths", "TRACKS"],
    ["--model_no", "3", "--bw_paths", "TRACKS", "--without_bw_distal",
     "--fused_stem", "on"],
    ["--trial_executor", "process", "--fused_stem", "on"],
    ["TRANSFER"]],
    ids=["host_eager", "host_groups", "resident_eager", "m0", "m1_fused",
         "m3_track_channels", "m3_cont_fused", "process", "transfer"])
def test_cli_bf16_runs_every_train_path(snv_data, tmp_path, monkeypatch,
                                        extra):
    """``--bf16`` on each train path of the port on the CPU: host-fed
    eager steps and groups, resident eager steps, SNVNet0/1/3 with track
    channels and with the fused stem, a spawned trial process and
    ``transfer``: the mixed-precision line in the trial's log, the
    triple with float32 tensors, a finite loss."""
    from mural_tpu_torch.cli.mural_snv import main as port_cli
    from test_torch_port_tracks import write_tracks
    fasta, bed = snv_data
    monkeypatch.chdir(tmp_path)
    if "TRACKS" in extra:
        tracks = write_tracks(tmp_path, np.random.default_rng(5),
                              {"chr1": 20_000})
        extra = [tracks if a == "TRACKS" else a for a in extra]
    command = "train"
    if extra == ["TRANSFER"]:
        assert port_cli(["train", "--ref_genome", fasta, "--train_data",
                         bed, "--experiment_name", "pre", *RUN,
                         *WIDTHS]) == 0
        ck = next((tmp_path / "results" / "pre").glob("Train_*"))
        model = str(ck / "checkpoint_0" / "model")
        command, extra = "transfer", ["--model_path", model,
                                      "--model_config_path",
                                      model + ".config.pkl"]
    else:
        extra = [*WIDTHS, *extra]
    assert port_cli([command, "--ref_genome", fasta, "--train_data", bed,
                     "--experiment_name", "b", *RUN, "--bf16",
                     *extra]) == 0
    trial = next((tmp_path / "results" / "b").glob("Train_*"))
    assert not (trial / "error.txt").exists()
    assert "mixed precision: bfloat16" in (trial / "training.log"
                                           ).read_text()
    sd = torch.load(trial / "checkpoint_0" / "model")
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())
    metrics = (trial / "checkpoint_0" / "epoch_0_metrics.txt").read_text()
    assert np.isfinite(float(metrics.splitlines()[0].split(":")[1]))


def test_cli_indel_train_bf16(tmp_path, monkeypatch, capsys):
    """``mural_indel train --bf16`` on the CPU at small widths: the triple
    and finite metrics; without ``--bf16`` the throughput note speaks of
    it, as the JAX CLI's does, with the factor measured on the card."""
    from mural_tpu_torch.cli.mural_indel import main as port_cli
    from test_torch_port_indel_cli import SMALL
    from test_torch_port_indel_train import write_indel_data
    fasta, bed = write_indel_data(tmp_path, np.random.default_rng(9),
                                  n_sites=480)
    monkeypatch.chdir(tmp_path)
    argv = ["train", "--cpu_only", "--ref_genome", fasta, "--train_data",
            bed, "--n_trials", "1", "--epochs", "1", "--valid_ratio",
            "0.5", "--split_seed", "0", *SMALL]
    assert port_cli([*argv, "--experiment_name", "b", "--bf16"]) == 0
    out = capsys.readouterr().out
    assert "--bf16 (bf16 activations" not in out
    trial = next((tmp_path / "results" / "b").glob("Train_*"))
    assert _checkpoint_files(trial, 0)[1:] == [
        "model", "model.config.pkl", "model.fdiri_cal.pkl"]
    progress = (trial / "progress.csv").read_text().splitlines()
    assert np.isfinite(float(progress[1].split(",")[4]))
    with pytest.raises(SystemExit):
        port_cli(["train", "--help"])
    assert "float32 parameters" in capsys.readouterr().out
    from mural_tpu_torch.cli.main import _advise_indel_throughput
    from mural_tpu_torch.cli.main import create_parser
    args = create_parser("indel").parse_args(
        ["train", "--ref_genome", fasta, "--train_data", bed,
         "--batch_size", "64"])
    _advise_indel_throughput(args, "indel")
    note = capsys.readouterr().out
    assert note.startswith("Throughput note: --bf16 (bf16 activations")
    assert "0.76-0.87x the float32 windows/s on an NVIDIA H100" in note
    assert "batch_size 64 leaves the card half dispatch-bound" in note


@pytest.mark.parametrize("backward", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("pk,pp,L", [(15, 7, 401), (3, 1, 201),
                                     (15, 7, 2001)])
@pytest.mark.parametrize("B", [1, 37, 128, 2048])
def test_bf16_launch_plan(B, pk, pp, L, backward):
    """The bf16 mode's launch plan (2-byte ``pooled`` and ``g``): every
    (row, window) pair in one piece, shared memory the kernels' layout
    and within one block, never more than the float32 mode's plan of the
    same cut takes."""
    from mural_tpu_torch.ops.fused_train_stem import (MAX_SMEM, _smem_bytes,
                                                      stem_launch_plan)
    plan = stem_launch_plan(B, L, 3, 32, pk, pp, backward, elem=2)
    hit = np.zeros((B, plan.P), np.int32)
    for b0, b1, p0, p1 in plan.pieces():
        hit[b0:b1, p0:p1] += 1
    assert (hit == 1).all()
    assert 0 < plan.smem <= MAX_SMEM
    assert plan.smem == _smem_bytes(3, 32, plan.rows, plan.p_tile, pk,
                                    plan.groups, backward, 2)
    assert plan.smem <= _smem_bytes(3, 32, plan.rows, plan.p_tile, pk,
                                    plan.groups, backward, 4)

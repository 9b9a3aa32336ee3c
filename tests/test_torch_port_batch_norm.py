"""Kernel K5 (``mural_tpu_torch/ops/batch_norm.py``): train-mode
BatchNorm over ``(N, C, L)`` activations.

On the CPU the port's ``BatchNorm1d`` runs the plain version, held here
against torch's ``F.batch_norm`` at scaled-down U-Net and SNV-tower
shapes in float32 and bfloat16: the output, the running statistics, the
batch counter and the gradients of x, weight and bias.  Eval mode and
2-D inputs run torch's BatchNorm; the registry's U-Net and SNVNet2 hold
the port's class in every BatchNorm of a 3-D activation with torch's
state_dict keys; the data-parallel swap and the vmapped ensemble's swap
reach every BatchNorm slot; the launch plan covers every shape.

Tests marked ``cuda`` skip without a card.  On the card they hold K5
against a float64 reference at the published shapes (every U-Net level
at B = 128 and the SNV towers), float32 and bfloat16, check that two
runs are bit-identical, that a CUDA graph replays K5 with the eager
step's numbers, and count its launches; run them there with ``python -m
pytest --noconftest -m cuda tests/test_torch_port_batch_norm.py`` (this
file imports no JAX).
"""
import copy
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from mural_tpu_torch.models.registry import build_model_from_config
from mural_tpu_torch.ops import batch_norm as bn
from mural_tpu_torch.ops._build import (add_launches, captured_launches,
                                        count_launches)
from mural_tpu_torch.parallel.sync_bn import (CrossRankBatchNorm,
                                              convert_batchnorm)
from mural_tpu_torch.train.ensemble import (_Float32BatchNorm,
                                            functional_model)

DTYPES = (torch.float32, torch.bfloat16)
# scaled-down (N, C, L): the U-Net's stem, a level-0 ConvBlock, deeper
# levels, its last level; SNV tower planes (odd lengths: the scalar path)
CPU_SHAPES = ((6, 4, 80), (6, 16, 80), (6, 24, 20), (6, 96, 2),
              (8, 32, 13), (8, 32, 7))

# the U-Net at the human INDEL recipe's widths, and SNVNet2 at the human
# SNV recipe's (windows cut for the CPU where a test says so)
UNET = dict(model_no=0, n_class=8, distal_radius=4000, CNN_kernel_size=7,
            CNN_out_channels=8, down_list=[1, 4, 5, 5, 5, 2],
            use_reverse=True, emb_dims=[(4, 1)] * 12)
SNV2 = dict(model_no=2, n_class=4, local_radius=7, local_order=3,
            local_hidden1_size=150, local_hidden2_size=75, emb_dropout=0.1,
            local_dropout=0.1, distal_fc_dropout=0.25, distal_radius=1000,
            CNN_kernel_size=3, CNN_out_channels=32, emb_dims=[(65, 2)] * 13)
MODELS = {"indel": UNET, "snv": SNV2}


def _model(kind):
    return build_model_from_config(MODELS[kind], 0, kind)


def _inputs(shape, dtype, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    N, C, L = shape
    # per-channel offsets and scales, as a conv's output has
    x = (torch.randn(shape, generator=gen) * (0.5 + torch.rand(
        (1, C, 1), generator=gen) * 3) + torch.randn((1, C, 1),
                                                      generator=gen) * 2)
    g = torch.randn(shape, generator=gen)
    w = 0.5 + torch.rand(C, generator=gen)
    b = torch.randn(C, generator=gen) * 0.3
    return (x.to(device, dtype), g.to(device, dtype), w.to(device),
            b.to(device))


def _pair(C, w, b, device="cpu"):
    """The port's BatchNorm1d and torch's, with the same parameters and
    non-trivial running statistics."""
    ours, ref = bn.BatchNorm1d(C).to(device), nn.BatchNorm1d(C).to(device)
    with torch.no_grad():
        for m in (ours, ref):
            m.weight.copy_(w)
            m.bias.copy_(b)
            m.running_mean.fill_(0.25)
            m.running_var.fill_(1.5)
            m.num_batches_tracked.fill_(3)
    return ours, ref


def _close(got, want, tol, what):
    got, want = got.detach().double(), want.detach().double()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("shape", CPU_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_matches_torch(shape, dtype):
    """On the CPU the port's BatchNorm1d gives torch's numbers bit for
    bit: the output, the gradients of x, weight and bias, the running
    statistics and the batch counter."""
    x, g, w, b = _inputs(shape, dtype)
    ours, ref = _pair(shape[1], w, b)
    xo, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    yo, yr = ours(xo), ref(xr)
    assert yo.dtype == dtype and yo.shape == x.shape
    yo.backward(g)
    yr.backward(g)
    for got, want in ((yo, yr), (xo.grad, xr.grad),
                      (ours.weight.grad, ref.weight.grad),
                      (ours.bias.grad, ref.bias.grad)):
        assert torch.equal(got, want)
    for a, c in zip(ours.buffers(), ref.buffers()):
        assert torch.equal(a, c)
    assert int(ours.num_batches_tracked) == 4


@pytest.mark.parametrize("shape", CPU_SHAPES[:3] + CPU_SHAPES[4:],
                         ids=lambda s: "x".join(map(str, s)))
def test_float64_reference_is_torchs_formula(shape):
    """The float64 reference that the card's tests hold K5 against
    (``_reference64``) is torch's train-mode BatchNorm, forward, backward
    and running statistics, in float64 on the CPU."""
    x, g, w, b = (t.double() for t in _inputs(shape, torch.float32))
    C = shape[1]
    rm, rv = torch.full((C,), 0.25).double(), torch.full((C,), 1.5).double()
    xr = x.clone().requires_grad_()
    wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
    rm2, rv2 = rm.clone(), rv.clone()
    y = F.batch_norm(xr, rm2, rv2, wr, br, True, 0.1, 1e-5)
    y.backward(g)
    got = _reference64(x, g, w, b, rm, rv)
    for a, c in zip(got[:6], (y, xr.grad, wr.grad, br.grad, rm2, rv2)):
        torch.testing.assert_close(a, c.detach(), rtol=1e-12, atol=1e-12)


def test_eval_and_2d_run_torch(monkeypatch):
    """Eval mode and (N, C) inputs never reach batch_norm_train; a train
    3-D input does, and the CPU tensor takes the plain version."""
    calls = []
    monkeypatch.setattr(bn, "batch_norm_train_plain",
                        lambda *a, **k: calls.append(a[0].shape) or a[0])
    m = bn.BatchNorm1d(3)
    m(torch.randn(4, 3))
    m(torch.randn(4, 3, 5))
    m.eval()
    m(torch.randn(4, 3, 5))
    m(torch.randn(4, 3))
    assert calls == [(4, 3, 5)]


def test_state_dict_and_options():
    m, ref = bn.BatchNorm1d(7), nn.BatchNorm1d(7)
    assert isinstance(m, nn.BatchNorm1d)
    sd, want = m.state_dict(), ref.state_dict()
    assert list(sd) == list(want)
    assert all(sd[k].dtype == want[k].dtype and sd[k].shape == want[k].shape
               for k in sd)
    m.load_state_dict(want)
    for kwargs in ({"affine": False}, {"track_running_stats": False},
                   {"momentum": None}):
        with pytest.raises(ValueError, match="port's BatchNorm"):
            bn.BatchNorm1d(7, **kwargs)


def test_input_errors():
    m = bn.BatchNorm1d(3)
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        m(torch.randn(1, 3, 1))
    with pytest.raises(ValueError, match="has 4 channels"):
        m(torch.randn(2, 4, 5))
    x = torch.randn(2, 3, 5, device="meta")
    p = [torch.zeros(3, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="unsupported device"):
        bn.batch_norm_train(x, *p, torch.zeros((), dtype=torch.int64,
                                               device="meta"), 1e-5, 0.1)


@pytest.mark.parametrize("kind", ["indel", "snv"])
def test_registry_models_hold_the_port_bn(kind):
    """Every BatchNorm of a 3-D activation (the U-Net's, the towers') is
    the port's class; the state_dict is torch's key for key."""
    model = _model(kind)
    bns = [(n, m) for n, m in model.named_modules()
           if isinstance(m, nn.BatchNorm1d)]
    ports = {n for n, m in bns if type(m) is bn.BatchNorm1d}
    if kind == "indel":
        assert ports == {n for n, _ in bns} and len(ports) == 36
    else:
        # the towers' 11 BNs each and the distal heads (2-D); the local
        # branch's 2-D BNs stay torch's
        towers = {n for n in ports if not n.startswith("distal_fc")}
        assert ports - towers == {"distal_fc1.0", "distal_fc2.0"}
        assert len(towers) == 22
        assert {n for n, m in bns if type(m) is nn.BatchNorm1d} == {
            "bn_layers.0", "bn_layers.1"}
    twin = copy.deepcopy(model)
    for m in twin.modules():
        if type(m) is bn.BatchNorm1d:
            m.__class__ = nn.BatchNorm1d
    sd, want = model.state_dict(), twin.state_dict()
    assert list(sd) == list(want)
    assert all(torch.equal(sd[k], want[k]) for k in sd)


@pytest.mark.parametrize("kind", ["indel", "snv"])
def test_swaps_reach_every_bn_slot(kind):
    """``convert_batchnorm`` (data parallelism) puts a CrossRankBatchNorm
    and ``functional_model`` (the vmapped ensemble) a _Float32BatchNorm in
    every BatchNorm slot, the port's included."""
    model = _model(kind)
    slots = sorted(n for n, m in model.named_modules()
                   if isinstance(m, nn.BatchNorm1d))
    tensors = {n: m.weight for n, m in model.named_modules()
               if isinstance(m, nn.BatchNorm1d)}
    dp = convert_batchnorm(copy.deepcopy(model))
    ens = functional_model(model)
    for swapped, cls in ((dp, CrossRankBatchNorm), (ens, _Float32BatchNorm)):
        got = {n: type(m) for n, m in swapped.named_modules()
               if isinstance(m, nn.BatchNorm1d)}
        assert sorted(got) == slots
        assert set(got.values()) == {cls}
    converted = convert_batchnorm(model)
    assert all(dict(converted.named_modules())[n].weight is t
               for n, t in tensors.items())


@pytest.mark.parametrize("kind", ["indel", "snv"])
def test_train_step_matches_torch_bn_on_cpu(kind):
    """A registry model's train forward and backward with the port's
    BatchNorm (the plain version on the CPU) against the same model with
    torch's: loss, every gradient and every buffer, bit for bit."""
    torch.manual_seed(0)
    cfg = dict(MODELS[kind], distal_radius=100 if kind == "indel" else 150)
    if kind == "indel":
        cfg["down_list"] = [1, 2, 5, 5, 2, 2]
    model = build_model_from_config(cfg, 0, kind)
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    twin = copy.deepcopy(model)
    for m in twin.modules():
        if type(m) is bn.BatchNorm1d:
            m.__class__ = nn.BatchNorm1d
    gen = torch.Generator().manual_seed(1)
    B, W = 6, 2 * cfg["distal_radius"] + (kind == "snv")
    distal = torch.eye(4)[torch.randint(0, 4, (B, W), generator=gen)]
    cat = torch.randint(0, 65, (B, 13), generator=gen)
    y = torch.randint(0, cfg["n_class"], (B,), generator=gen)
    losses = []
    for m in (model, twin):
        m.train()
        loss = F.cross_entropy(m(cat, distal), y)
        loss.backward()
        losses.append(loss)
    assert torch.equal(losses[0], losses[1])
    grads = dict(twin.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, grads[n].grad), n
    bufs = dict(twin.named_buffers())
    for n, t in model.named_buffers():
        assert torch.equal(t, bufs[n]), n


def test_captured_launches_count_at_each_replay():
    """K5's launches on a stream that a graph is capturing go to the
    capture's tally, not the total; each replay adds the tally."""
    class Stream:
        cuda_stream = 4242

    before = bn.LAUNCHES
    with captured_launches(Stream()) as tally:
        count_launches(bn, "LAUNCHES", 2, 4242)
        count_launches(bn, "LAUNCHES", 2, 4242)
        count_launches(bn, "LAUNCHES", 2, 7)    # another stream: now
    assert tally == {(bn, "LAUNCHES"): 4} and bn.LAUNCHES == before + 2
    for _ in range(3):
        add_launches(tally)
    count_launches(bn, "LAUNCHES", 2, 4242)     # no capture any more
    assert bn.LAUNCHES == before + 16


def test_launch_args_match_the_kernels_struct():
    """``_Args`` lists ``K5Args`` of ``csrc/batch_norm.cu`` field for
    field, each of the C type's size, so the launchers read what the
    wrapper wrote."""
    import ctypes
    import re
    src = (Path(bn.__file__).parent / "csrc" / "batch_norm.cu").read_text()
    body = re.search(r"struct K5Args \{(.*?)\};", src, re.S).group(1)
    sizes = {"void*": 8, "float*": 8, "long long*": 8, "cudaStream_t": 8,
             "long long": 8, "int": 4, "float": 4}
    fields = []
    for decl in body.split(";")[:-1]:
        decl = " ".join(decl.replace("const ", "").split())
        kind = next(k for k in sorted(sizes, key=len, reverse=True)
                    if decl.startswith(k))
        for name in decl[len(kind):].replace("*", "").split(","):
            fields.append((name.strip(), sizes[kind]))
    ours = [(name, ctypes.sizeof(t)) for name, t in bn._Args._fields_]
    assert ours == fields


# (N, C, L) of every train-mode BatchNorm of the published models at B =
# 128: the U-Net's stem, its levels (c, 2c of a ConvBlock) at the human
# INDEL recipe, and the SNV towers' planes at the human SNV recipe
UNET_SHAPES = ((128, 4, 8000), (128, 8, 8000), (128, 16, 8000),
               (128, 16, 2000), (128, 32, 2000), (128, 24, 400),
               (128, 48, 400), (128, 32, 80), (128, 64, 80), (128, 40, 16),
               (128, 80, 16), (128, 48, 8), (128, 96, 8))
SNV_SHAPES = ((128, 32, 134), (128, 32, 20), (128, 32, 7), (128, 32, 67),
              (128, 32, 23), (128, 32, 8))


@pytest.mark.parametrize("shape", UNET_SHAPES + SNV_SHAPES + (
    (1, 1, 2), (3, 5, 4097), (1000, 2, 3)), ids=lambda s: "x".join(
        map(str, s)))
def test_launch_plan_covers_each_channel(shape):
    N, C, L = shape
    for vec in ((1, 4) if L % 4 == 0 else (1,)):
        S, chunk = bn.bn_launch_plan(N, C, L, vec)
        Q = N * L // vec
        assert (S - 1) * chunk < Q <= S * chunk and Q < 2 ** 31
        assert chunk * vec <= bn.MAX_BLOCK_ELEMENTS
        # the card is filled, or each block holds about its least work
        assert S * C >= bn.TARGET_BLOCKS \
            or S == -(-Q // bn.MIN_BLOCK_VECTORS)
    if shape == (128, 4, 8000):
        assert bn.bn_launch_plan(N, C, L, 4)[0] * C >= bn.TARGET_BLOCKS


# --- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 is a CUDA kernel with no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _reference64(x, g, w, b, rm, rv, eps=1e-5, momentum=0.1):
    """Train-mode BatchNorm and its backward in float64."""
    x, g = x.double(), g.double()
    M = x.shape[0] * x.shape[2]
    mean = x.mean((0, 2))
    xm = x - mean[:, None]
    var = (xm * xm).mean((0, 2))
    rstd = 1 / torch.sqrt(var + eps)
    xhat = xm * rstd[:, None]
    y = xhat * w.double()[:, None] + b.double()[:, None]
    db = g.sum((0, 2))
    dw = (g * xhat).sum((0, 2))
    dx = (w.double() * rstd)[:, None] * (g - db[:, None] / M
                                         - xhat * dw[:, None] / M)
    rm = (1 - momentum) * rm.double() + momentum * mean
    rv = (1 - momentum) * rv.double() + momentum * var * M / (M - 1)
    return y, dx, dw, db, rm, rv, (g.abs().sum((0, 2)),
                                   (g * xhat).abs().sum((0, 2)))


def _k5_run(x, g, w, b):
    m, _ = _pair(x.shape[1], w, b, x.device)
    xg = x.clone().requires_grad_()
    y = m(xg)
    y.backward(g)
    torch.cuda.synchronize()
    return y, xg.grad, m


@pytest.mark.cuda
@pytest.mark.parametrize("shape", UNET_SHAPES + SNV_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_k5_matches_float64(card, shape, dtype):
    """K5 against the float64 reference on the same (dtype-rounded)
    inputs.  float32: outputs and dx within 1e-5 of their largest entry
    (float32 statistics and a few roundings an element); dweight and
    dbias within 1e-5 of the sum of their terms' magnitudes (float32
    partial sums of up to ~10^4 terms a block); running statistics within
    1e-5 relative.  bfloat16: outputs and dx rounded once to bfloat16 (half
    an ulp, at most 2^-8 of the value), and the float32 value may sit
    across a rounding boundary from the float64 one: within one ulp (2^-7)
    of each element plus 1e-5 of the largest."""
    x, g, w, b = _inputs(shape, dtype, card, seed=sum(shape))
    y, dx, m = _k5_run(x, g, w, b)
    ry, rdx, rdw, rdb, rrm, rrv, (sdb, sdw) = _reference64(
        x, g, w, b, torch.full_like(w, 0.25), torch.full_like(w, 1.5))
    assert y.dtype == dtype and dx.dtype == dtype
    for got, want, what in ((y, ry, "y"), (dx, rdx, "dx")):
        err = (got.double() - want).abs()
        bound = 1e-5 * float(want.abs().max())
        if dtype == torch.bfloat16:
            bound = bound + 2.0 ** -7 * want.abs()
        assert bool((err <= bound).all()), \
            f"{what}: worst {float((err - bound).max())} over its bound"
    assert bool(((m.weight.grad.double() - rdw).abs() <= 1e-5 * sdw).all())
    assert bool(((m.bias.grad.double() - rdb).abs() <= 1e-5 * sdb).all())
    assert bool(((m.running_mean.double() - rrm).abs()
                 <= 1e-5 * rrm.abs().clamp(min=1)).all())
    assert bool(((m.running_var.double() - rrv).abs() <= 1e-5 * rrv).all())
    assert int(m.num_batches_tracked) == 4


@pytest.mark.cuda
def test_k5_takes_an_unaligned_gradient(card):
    """A dy whose start is not 16-byte aligned is copied to an aligned
    tensor, and the backward runs the forward's plan on the copy: dx,
    dweight and dbias as the float64 reference's (bounds as above)."""
    x, g, w, b = _inputs((16, 8, 400), torch.float32, card, seed=5)
    m, _ = _pair(8, w, b, card)
    xg = x.clone().requires_grad_()
    room = torch.empty(g.numel() + 1, device=card)
    dy = room[1:].view_as(g)
    dy.copy_(g)
    assert dy.data_ptr() % 16 != 0
    dx, dw, db = torch.autograd.grad(m(xg), (xg, m.weight, m.bias), dy)
    _, rdx, rdw, rdb, _, _, (sdb, sdw) = _reference64(
        x, g, w, b, torch.full_like(w, 0.25), torch.full_like(w, 1.5))
    assert float((dx.double() - rdx).abs().max()) <= 1e-5 * float(
        rdx.abs().max())
    assert bool(((dw.double() - rdw).abs() <= 1e-5 * sdw).all())
    assert bool(((db.double() - rdb).abs() <= 1e-5 * sdb).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((128, 8, 8000), (128, 32, 134)),
                         ids=lambda s: "x".join(map(str, s)))
def test_k5_repeats_bit_for_bit(card, shape):
    x, g, w, b = _inputs(shape, torch.float32, card)
    first, second = _k5_run(x, g, w, b), _k5_run(x, g, w, b)
    for a, c in zip(first[:2], second[:2]):
        assert torch.equal(a, c)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(first[2], name), getattr(second[2], name))
    assert torch.equal(first[2].weight.grad, second[2].weight.grad)
    assert torch.equal(first[2].bias.grad, second[2].bias.grad)


@pytest.mark.cuda
def test_k5_counts_its_launches(card):
    x, g, w, b = _inputs((16, 8, 100), torch.float32, card)
    before = bn.LAUNCHES
    y = bn.BatchNorm1d(8).to(card)(x.requires_grad_())
    assert bn.LAUNCHES == before + 2
    y.backward(g)
    assert bn.LAUNCHES == before + 4
    with torch.no_grad():
        bn.BatchNorm1d(8).to(card).eval()(x)
    assert bn.LAUNCHES == before + 4


@pytest.mark.cuda
def test_k5_replays_in_a_cuda_graph(card):
    """A train step (a learned input -> BN -> ReLU -> BN, loss, backward:
    deterministic ops only) captured in a CUDA graph replays K5 with the
    eager step's numbers, and each replay counts the launches the capture
    recorded."""
    torch.manual_seed(0)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.x = nn.Parameter(torch.randn(128, 32, 134))
            self.body = nn.Sequential(bn.BatchNorm1d(32), nn.ReLU(),
                                      bn.BatchNorm1d(32))

        def forward(self):
            return self.body(self.x)

    net = Net().to(card)
    start = copy.deepcopy(net.state_dict())

    def step(model):
        loss = model().square().mean()
        loss.backward()
        return loss

    eager = copy.deepcopy(net)
    eager_loss = step(eager)
    graphed = copy.deepcopy(net)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        step(graphed)                 # warm-up on the capture stream
    torch.cuda.current_stream(card).wait_stream(stream)
    graphed.load_state_dict(start)
    for p in graphed.parameters():
        p.grad = None
    graph = torch.cuda.CUDAGraph()
    before = bn.LAUNCHES
    with captured_launches(stream) as tally, \
            torch.cuda.graph(graph, stream=stream):
        static_loss = step(graphed)
    assert tally == {(bn, "LAUNCHES"): 8} and bn.LAUNCHES == before
    graph.replay()
    add_launches(tally)
    torch.cuda.synchronize()
    assert bn.LAUNCHES == before + 8
    assert torch.equal(static_loss, eager_loss)
    for (n, p), q in zip(graphed.named_parameters(), eager.parameters()):
        assert torch.equal(p.grad, q.grad), n
    for (n, t), u in zip(graphed.named_buffers(), eager.buffers()):
        assert torch.equal(t, u), n


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["indel", "snv"])
def test_k5_model_step_matches_cudnn(card, kind):
    """A registry model's train forward and backward at the published
    widths (B = 16) with K5 against the same model on cuDNN's BatchNorm:
    losses within 1e-5, gradients within 1e-3 of each leaf's largest
    entry (36 or 20 BatchNorms in a row of float32 statistics summed in
    another order)."""
    torch.manual_seed(0)
    model = _model(kind).to(card)
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    twin = copy.deepcopy(model)
    for m in twin.modules():
        if type(m) is bn.BatchNorm1d:
            m.__class__ = nn.BatchNorm1d
    B = 16
    W = 2 * MODELS[kind]["distal_radius"] + (kind == "snv")
    distal = torch.eye(4, device=card)[torch.randint(0, 4, (B, W),
                                                     device=card)]
    cat = torch.randint(0, 65, (B, 13), device=card)
    y = torch.randint(0, MODELS[kind]["n_class"], (B,), device=card)
    before = bn.LAUNCHES
    losses = []
    for m in (model, twin):
        loss = F.cross_entropy(m(cat, distal), y)
        loss.backward()
        losses.append(loss)
    assert bn.LAUNCHES - before == 4 * (36 if kind == "indel" else 22)
    _close(losses[0], losses[1], 1e-5, "loss")
    grads = dict(twin.named_parameters())
    for n, p in model.named_parameters():
        _close(p.grad, grads[n].grad, 1e-3, n)

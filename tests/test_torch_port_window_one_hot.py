"""Kernel K4 (``mural_tpu_torch/ops/window_one_hot.py``): the
strand-resolved one-hot of genome windows.

On the CPU the wrappers run their plain versions, held here against a
numpy one-hot of the same windows (the minus rows flipped on both axes):
mixed strands, every code 0-15 (the fractional rows and the zero
sentinel), windows at both ends of the source, an empty batch, width 1,
float32 and bfloat16, and ``one_hot_from_codes`` on 2-D, 1-D, 3-D and
row-strided codes.  The three call sites (the genome-wide encoder,
resident training's unfused batches, ``one_hot_from_codes`` under
``model_input``) route through the op; the fused paths do not.

Tests marked ``cuda`` skip without a card.  On the card they hold K4
bit-equal to the plain version at the main path's shapes and count its
launches; run them there with ``python -m pytest --noconftest -m cuda
tests/test_torch_port_window_one_hot.py`` (this file imports no JAX).
"""
import numpy as np
import pytest
import torch

from mural_tpu_torch.models import layers
from mural_tpu_torch.ops import window_one_hot as wo
from mural_tpu_torch.ops.device_gather import (make_batch_code_encoder,
                                               make_batch_encoder)
from mural_tpu_torch.train import steps
from mural_tpu_torch.train.resident import ResidentData
from mural_tpu_torch.utils import spans

DTYPES = (torch.float32, torch.bfloat16)
# the bit patterns of each dtype, for bit-equality
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def expected(src: np.ndarray, starts, width, neg, dtype):
    """numpy one-hot of the windows, minus rows flipped on both axes."""
    rows = []
    for i, s in enumerate(starts):
        oh = wo.ONE_HOT16[src[s:s + width]]
        rows.append(oh[::-1, ::-1] if neg is not None and neg[i] else oh)
    out = np.stack(rows) if rows else np.zeros((0, width, 4), np.float32)
    return torch.from_numpy(np.ascontiguousarray(out)).to(dtype)


def assert_bits_equal(got: torch.Tensor, want: torch.Tensor):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous()
    bits = BITS[got.dtype]
    assert torch.equal(got.cpu().view(bits), want.cpu().view(bits))


def strands(kind, n, rng):
    if kind is None:
        return None
    return {"mixed": rng.random(n) < 0.5, "plus": np.zeros(n, bool),
            "minus": np.ones(n, bool)}[kind]


@pytest.mark.parametrize("kind", ["mixed", "plus", "minus", None])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_matches_numpy(kind, dtype):
    rng = np.random.default_rng(7)
    src = rng.integers(0, 16, 500).astype(np.uint8)
    width = 37
    starts = rng.integers(0, len(src) - width + 1, 23)
    neg = strands(kind, len(starts), rng)
    got = wo.window_one_hot(torch.from_numpy(src), torch.from_numpy(starts),
                            width, None if neg is None
                            else torch.from_numpy(neg), dtype)
    assert_bits_equal(got, expected(src, starts, width, neg, dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_every_code_and_the_sentinel(dtype):
    src = np.arange(16, dtype=np.uint8)
    neg = np.array([False, True])
    got = wo.window_one_hot(torch.from_numpy(src), torch.tensor([0, 0]), 16,
                            torch.from_numpy(neg), dtype).float()
    table = torch.from_numpy(wo.ONE_HOT16).to(dtype).float()
    assert torch.equal(got[0], table)
    assert torch.equal(got[1], table.flip((0, 1)))
    assert torch.all(got[0, 15] == 0)
    assert torch.equal(got[0, 14], torch.full((4,), 0.25))   # N
    assert got[0, 10, 1] == table[10, 1] and 0 < table[10, 1] < 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_windows_at_both_ends(dtype):
    rng = np.random.default_rng(3)
    src = rng.integers(0, 15, 64).astype(np.uint8)
    width = 20
    starts = np.array([0, 0, 44, 44, 44 - 1])
    neg = np.array([False, True, False, True, True])
    got = wo.window_one_hot(torch.from_numpy(src), torch.from_numpy(starts),
                            width, torch.from_numpy(neg), dtype)
    assert_bits_equal(got, expected(src, starts, width, neg, dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_empty_batch(dtype):
    src = torch.zeros(50, dtype=torch.uint8)
    got = wo.window_one_hot(src, torch.zeros(0, dtype=torch.int64), 8,
                            torch.zeros(0, dtype=torch.bool), dtype)
    assert got.shape == (0, 8, 4) and got.dtype == dtype


@pytest.mark.parametrize("kind", ["mixed", None])
def test_width_one(kind):
    rng = np.random.default_rng(11)
    src = rng.integers(0, 16, 30).astype(np.uint8)
    starts = np.arange(30)
    neg = strands(kind, 30, rng)
    got = wo.window_one_hot(torch.from_numpy(src), torch.from_numpy(starts),
                            1, None if neg is None else torch.from_numpy(neg))
    assert_bits_equal(got, expected(src, starts, 1, neg, torch.float32))


@pytest.mark.parametrize("form", ["2d", "1d", "3d", "strided"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_one_hot_from_codes_forms(form, dtype):
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 16, (6, 40)).astype(np.uint8))
    codes = {"2d": codes, "1d": codes[0], "3d": codes.view(2, 3, 40),
             "strided": codes[:, 5:25]}[form]
    got = wo.one_hot_from_codes(codes, dtype)
    want = torch.from_numpy(wo.ONE_HOT16[codes.numpy()]).to(dtype)
    assert got.shape == (*codes.shape, 4)
    assert torch.equal(got.view(BITS[dtype]), want.view(BITS[dtype]))


def test_models_use_the_op():
    assert layers.one_hot_from_codes is wo.one_hot_from_codes
    assert steps.one_hot_from_codes is wo.one_hot_from_codes


def test_other_devices_raise():
    """A tensor on neither the CPU nor a card never takes the plain
    version: the wrappers raise."""
    src = torch.zeros(20, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wo.window_one_hot(src, torch.zeros(2, dtype=torch.int64,
                                           device="meta"), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        wo.one_hot_from_codes(src.view(4, 5))


def _resident(rng, width):
    n = 12
    arena = torch.from_numpy(rng.integers(0, 15, 300).astype(np.uint8))
    return ResidentData(
        arena=arena, y=torch.zeros(n, dtype=torch.uint8),
        cat=torch.zeros((n, 2), dtype=torch.uint8), cont=None,
        astart=torch.from_numpy(rng.integers(0, 300 - width + 1, n)),
        neg=torch.from_numpy(rng.random(n) < 0.5), distal_width=width,
        n_sites=n)


def _sites(rng):
    chunk = torch.from_numpy(rng.integers(0, 15, 400).astype(np.uint8))
    starts = torch.from_numpy(rng.integers(0, 300, 9))
    return chunk, starts, starts + 10, torch.from_numpy(rng.random(9) < 0.5)


@pytest.mark.parametrize("site", ["encoder", "resident", "model_input",
                                  "code_encoder", "resident_fused",
                                  "model_input_fused"])
def test_call_sites_route_through_the_op(site, monkeypatch):
    """The one-hot call sites reach the op's plain version on the CPU
    (and so K4 on a card); the fused paths, which read codes, do not."""
    calls = []
    for name in ("window_one_hot_plain", "one_hot_from_codes_plain"):
        inner = getattr(wo, name)
        monkeypatch.setattr(wo, name, lambda *a, inner=inner, name=name,
                            **k: calls.append(name) or inner(*a, **k))
    rng = np.random.default_rng(2)
    routed = {"encoder": "window_one_hot_plain",
              "resident": "window_one_hot_plain",
              "model_input": "one_hot_from_codes_plain"}.get(site)
    if site in ("encoder", "code_encoder"):
        make = make_batch_encoder if site == "encoder" \
            else make_batch_code_encoder
        encode, _, dw = make(3, 2, 40, "snv")
        chunk, lstart, dstart, neg = _sites(rng)
        _, distal = encode(chunk, lstart, dstart, neg)
        want = (expected(chunk.numpy(), dstart.numpy(), dw, neg.numpy(),
                         torch.float32) if routed else None)
    elif site in ("resident", "resident_fused"):
        res = _resident(rng, 50)
        rows = torch.tensor([0, 3, 5, 11])
        distal = res.batch(rows, site == "resident_fused")[2]
        want = (expected(res.arena.numpy(), res.astart[rows].numpy(), 50,
                         res.neg[rows].numpy(), torch.float32)
                if routed else None)
    else:
        codes = torch.from_numpy(rng.integers(0, 16, (4, 30))
                                 .astype(np.uint8))
        distal = steps.model_input(codes, site == "model_input_fused")
        want = (torch.from_numpy(wo.ONE_HOT16[codes.numpy()])
                if routed else None)
    if routed:
        assert calls[:1] == [routed]
        assert_bits_equal(distal, want)
    else:
        assert calls == [] and distal.dtype == torch.uint8


# --- on the card ----------------------------------------------------------

# (B, width) of the main path: the INDEL map's batch, INDEL training's,
# and the unfused SNV map's
CARD_SHAPES = ((4096, 8000), (128, 8000), (4096, 2001))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def _card_inputs(card, B, width, seed):
    gen = torch.Generator().manual_seed(seed)
    # a genome-wide chunk: 4 Mb and the window's margins
    src = torch.randint(0, 16, ((1 << 22) + 2 * width,), generator=gen,
                        dtype=torch.uint8)
    starts = torch.randint(0, src.shape[0] - width + 1, (B,), generator=gen)
    starts[:2] = torch.tensor([0, src.shape[0] - width])
    neg = torch.rand(B, generator=gen) < 0.5
    return src.to(card), starts.to(card), neg.to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_k4_bit_equal_on_card(card, shape, dtype):
    B, width = shape
    src, starts, neg = _card_inputs(card, B, width, B + width)
    for n in (neg, None):
        got = wo.window_one_hot(src, starts, width, n, dtype)
        want = wo.window_one_hot_plain(src, starts, width, n, dtype)
        torch.cuda.synchronize()
        assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_k4_one_hot_from_codes_on_card(card, dtype):
    gen = torch.Generator().manual_seed(1)
    codes = torch.randint(0, 16, (128, 8000), generator=gen,
                          dtype=torch.uint8).to(card)
    for c in (codes, codes[:, 100:2101], codes[0], codes.view(2, 64, 8000)):
        got = wo.one_hot_from_codes(c, dtype)
        assert_bits_equal(got, wo.one_hot_from_codes_plain(c, dtype))


@pytest.mark.cuda
def test_k4_counts_its_launches_and_rows(card):
    src, starts, neg = _card_inputs(card, 16, 100, 0)
    codes = src[:1600].view(16, 100)
    before = wo.LAUNCHES
    with spans.recording() as session:
        wo.window_one_hot(src, starts, 100, neg)
        assert wo.LAUNCHES == before + 1
        wo.one_hot_from_codes(codes[:5])
        assert wo.LAUNCHES == before + 2
        wo.window_one_hot(src, starts[:0], 100, neg[:0])   # no launch
        assert wo.LAUNCHES == before + 2
    assert spans.totals(session)["feed.onehot_rows"] == (2, 21.0)


def test_plain_version_counts_nothing():
    before = wo.LAUNCHES
    with spans.recording() as session:
        wo.window_one_hot(torch.zeros(9, dtype=torch.uint8),
                          torch.tensor([0, 2]), 4)
        wo.one_hot_from_codes(torch.zeros((2, 3), dtype=torch.uint8))
    assert wo.LAUNCHES == before
    assert "feed.onehot_rows" not in spans.totals(session)

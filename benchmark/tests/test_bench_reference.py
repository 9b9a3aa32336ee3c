"""The plain references against the measured program at tiny widths, on
the CPU: one set of weights loads into both, and their outputs, losses
and gradients agree."""

import pytest
import torch

from harness import gen
from reference import train as rtrain
from reference.models import build_reference
import tiny


def _pair(name, trained):
    from mural_tpu_torch.models.registry import build_model
    c = tiny.cell(name)
    cfg = c.config
    n_cat = (2 * cfg["local_radius"] + 1 - cfg["local_order"] + 1
             if cfg["model_type"] == "snv" else 1)
    vocab = 4 ** cfg["local_order"] + 1
    common = {"emb_dims": [(vocab, 2)] * n_cat, "n_cont": 0,
              "n_class": cfg["n_class"], "in_channels": 4}
    prog = build_model(cfg["model_no"], cfg, common, cfg["model_type"])
    ref = build_reference(cfg, n_cat)
    w = gen.weights(ref, 7, "cpu", trained=trained)
    prog.load_state_dict(w)
    ref.load_state_dict(w)
    return cfg, n_cat, prog, ref


def _inputs(cfg, n_cat, B=6):
    g = torch.Generator().manual_seed(3)
    width = 2 * cfg["distal_radius"] + (cfg["model_type"] == "snv")
    codes = torch.randint(0, 4, (B, width), generator=g)
    onehot = torch.nn.functional.one_hot(codes, 4).float()
    cat = torch.randint(0, 4 ** cfg["local_order"] + 1, (B, n_cat),
                        generator=g)
    y = torch.randint(0, cfg["n_class"], (B,), generator=g)
    return cat, onehot, y


@pytest.mark.parametrize("name", ["snv_hs.genome", "indel_hs.genome"])
def test_forward_matches_the_program(name):
    cfg, n_cat, prog, ref = _pair(name, trained=True)
    cat, onehot, _ = _inputs(cfg, n_cat)
    prog.eval()
    ref.eval()
    with torch.no_grad():
        want = ref(cat, onehot.transpose(1, 2))
        got = prog(cat, onehot)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["snv_hs.train", "indel_hs.train"])
def test_train_step_matches_the_program(name):
    """One train-mode step, dropout included: the reference's float32
    masks are the program's draws from the same generator state."""
    from mural_tpu_torch.train.steps import masked_ce_sum
    cfg, n_cat, prog, ref = _pair(name, trained=False)
    ref = rtrain.with_mask_dropout(ref)
    cat, onehot, y = _inputs(cfg, n_cat)
    prog.train()
    ref.train()
    torch.manual_seed(11)
    loss_p = masked_ce_sum(prog(cat, onehot), y, torch.ones(len(y)))
    loss_p.backward()
    torch.manual_seed(11)
    loss_r = rtrain.ce_sum(ref(cat, onehot.transpose(1, 2)), y)
    loss_r.backward()
    torch.testing.assert_close(loss_p, loss_r, rtol=1e-5, atol=1e-5)
    grads = dict(ref.named_parameters())
    for k, p in prog.named_parameters():
        torch.testing.assert_close(p.grad, grads[k].grad, rtol=1e-4,
                                   atol=1e-5)


def test_adam_matches_torch():
    """The reference's Adam and AdamW (amsgrad) written out agree with
    torch's."""
    for name, cls, kw in (("Adam", torch.optim.Adam, {}),
                          ("AdamW", torch.optim.AdamW, {"amsgrad": True})):
        g = torch.Generator().manual_seed(5)
        p0 = torch.randn(10, generator=g, dtype=torch.float64)
        grads = [torch.randn(10, generator=g, dtype=torch.float64)
                 for _ in range(3)]
        a = p0.clone().requires_grad_()
        opt = cls([a], lr=1e-3, weight_decay=0.01, **kw)
        b = {"w": p0.clone()}
        mine = rtrain.Adam(b, name, 0.01)
        for gr in grads:
            a.grad = gr.clone()
            opt.step()
            mine.step({"w": gr.clone()}, 1e-3)
        torch.testing.assert_close(b["w"], a.detach(), rtol=1e-12,
                                   atol=1e-14)

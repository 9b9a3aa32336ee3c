"""Train cells: the train step path of ``train_trial`` (``train/loop.py``)
on device-resident data, driven with no step logic of the harness's own.

Set-up makes a genome and the training sites from the seed, lets the
program prepare the dataset (``prepare_dataset``), build the model and
its optimizer (``build_model``, ``GraphOptimizer``, ``TrainState``), the
resident arrays and one epoch's rows (``make_resident``,
``stack_epoch_rows``) and the step groups (``StepGroups`` on
``resident_batch``), all as ``train_trial`` does, with the benchmark's
weights loaded.  Steps 1-3 go through ``StepGroups.run`` as groups
shorter than K (eager steps of the same step function, the path a
group's leftovers take); the plain reference follows them from the same
weights.  Then one group of K captures the CUDA graph and two replay it
(warm-up), and the window runs ``resident_epoch`` on chunks of the
epoch's rows until ``--seconds`` have passed, one chunk in flight ahead
of the host.  After the window one more group of K goes through the
same path (a replay of the window's graph where K > 1), and the
reference follows its K steps from the program's state before it.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from harness import checks as ck
from harness import gen
from harness.outcome import Outcome
from harness.trace import Tracer
from reference import data as rdata
from reference import train as rtrain
from reference.models import build_reference

CHECK_STEPS = 3


def _rng_state(device):
    return (torch.cuda.get_rng_state(device) if device.type == "cuda"
            else torch.get_rng_state())


def _set_rng_state(device, state):
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Setup:
    """The program's objects of one train cell, built from the seed."""

    def __init__(self, cell, seed: int, device: torch.device):
        from mural_tpu_torch.data.dataset import prepare_dataset
        from mural_tpu_torch.genome.bed import BedFile
        from mural_tpu_torch.genome.fasta import Genome
        from mural_tpu_torch.models.registry import build_model
        from mural_tpu_torch.train.graphs import (StepGroups, epoch_scalars,
                                                  steps_per_dispatch)
        from mural_tpu_torch.train.loop import seed_device
        from mural_tpu_torch.train.optim import (GraphOptimizer, LRSchedule,
                                                 auto_weight_decay)
        from mural_tpu_torch.train.resident import (make_resident,
                                                    resident_batch,
                                                    stack_epoch_rows,
                                                    upload_rows)
        from mural_tpu_torch.train.steps import TrainState
        from mural_tpu_torch.device import to_device

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.device = cfg, device
        self.model_type = cfg["model_type"]
        B = self.B = cfg["batch_size"]
        # the inputs: genome, sites, labels
        codes = gen.genome(seed, cfg["train_genome_bases"], device)
        pos, neg, y = gen.sites(seed, codes, cfg["train_sites"],
                                cfg["focal_base"], cfg["distal_radius"] + 8,
                                cfg["mutated_share"], cfg["n_class"])
        self.codes, self.site_keys = codes, np.sort(
            _site_key(pos, neg, y))
        bed = BedFile(["chr1"] * len(pos), pos, pos + 1, y, neg)
        ds = prepare_dataset(
            bed, Genome({"chr1": codes}), central_bp=cfg["segment_center"],
            local_radius=cfg["local_radius"], local_order=cfg["local_order"],
            distal_radius=cfg["distal_radius"], model_type=self.model_type)
        self.ds = ds
        # the model, as train_trial builds it, with the benchmark's weights
        config = dict(cfg)
        config["emb_dims"] = [(x, min(16, int(x ** 0.25)))
                              for x in ds.cat_dims]
        common = {"emb_dims": config["emb_dims"], "n_cont": 0,
                  "n_class": cfg["n_class"], "in_channels": 4}
        model = build_model(cfg["model_no"], config, common, self.model_type)
        self.n_cat = ds.cat.shape[1]
        shape_model = build_reference(cfg, self.n_cat)
        self.init = gen.weights(shape_model, seed, device, trained=False)
        model.load_state_dict(self.init)
        model.to(device)
        self.model = model
        wd = auto_weight_decay(cfg.get("weight_decay_auto"), B,
                               cfg["epochs"], cfg["recipe_train_sites"],
                               cfg.get("weight_decay", 0.0))
        schedule = LRSchedule.build(
            cfg["lr_scheduler"], cfg["learning_rate"], cfg["LR_gamma"], B,
            cfg["recipe_train_sites"], cfg["restart_lr"], cfg["min_lr"])
        self.opt = GraphOptimizer(cfg["optim"], list(model.parameters()), wd)
        self.state = TrainState(model, self.opt, schedule)
        # the feed: resident arrays and one epoch's rows
        res = make_resident(ds, device)
        self.rows_np, _, _ = stack_epoch_rows(
            ds, cfg["sampled_segments"], B, shuffle=True,
            rng=np.random.default_rng(gen.stream(seed, "rows")))
        self.rows = upload_rows(self.rows_np, device)
        self.n_steps = len(self.rows_np)
        self.k = steps_per_dispatch(tr.get("steps_per_dispatch"),
                                    self.model_type)
        # train_trial's rule: the fused stem is the SNV towers'
        fused = (tr.get("fused_stem") == "on" and self.model_type == "snv"
                 and cfg["model_no"] in (1, 2, 3))
        self.groups = StepGroups(self.state, self.k, resident_batch(
            res, fused, torch.ones(B, device=device)))
        self.scalars = to_device(epoch_scalars(self.state, self.n_steps),
                                 device)
        seed_device(device, gen.stream(seed, "dropout"))
        self.names = [n for n, _ in model.named_parameters()]

    def run(self, lo: int, hi: int) -> torch.Tensor:
        """Steps ``lo``..``hi - 1`` of the epoch through the program."""
        from mural_tpu_torch.train.resident import resident_epoch
        return resident_epoch(self.groups, self.rows[lo:hi],
                              self.scalars[lo:hi])

    def snapshot(self) -> Dict:
        """The program's state before its next step: parameters, buffers,
        the optimizer's moments, the step count, the dropout stream."""
        return {
            "state": {k: v.detach().clone()
                      for k, v in self.model.state_dict().items()},
            "moments": {k: [t.detach().clone() for t in v]
                        for k, v in self.opt.state.items()},
            "step": self.state.step,
            "rng": _rng_state(self.device),
        }

    # --- what the reference reads -----------------------------------
    def batch_inputs(self, step: int, dtype):
        """The reference's own inputs for the program's batch ``step``:
        windows gathered from the genome, k-mer ids and one-hot worked
        out again; returns ((cat, onehot, y), rows that are no site of
        the benchmark's)."""
        cfg, ds = self.cfg, self.ds
        rows = self.rows_np[step]
        pos, neg, y = ds.start[rows], ds.strand_neg[rows], ds.y[rows]
        bad = int((~np.isin(_site_key(pos, neg, y), self.site_keys)).sum())
        dwin = rdata.windows(self.codes, pos, neg, cfg["distal_radius"],
                             self.model_type)
        lwin = rdata.windows(self.codes, pos, neg, cfg["local_radius"],
                             self.model_type)
        dev = self.device
        cat = torch.from_numpy(rdata.kmer_ids(lwin, cfg["local_order"]))
        onehot = torch.from_numpy(rdata.one_hot(dwin))
        return ((cat.to(dev), onehot.to(dev, dtype),
                 torch.from_numpy(y.astype(np.int64)).to(dev)), bad)

    def lr(self, step: int) -> float:
        """MuRaL's StepLR: ``lr * gamma ** (step // (5000 * 128 / B))``."""
        cfg = self.cfg
        size = max(5000 * 128 // self.B, 1)
        return cfg["learning_rate"] * cfg["LR_gamma"] ** (step // size)

    def weight_decay(self) -> float:
        cfg = self.cfg
        wda = cfg.get("weight_decay_auto")
        if wda is not None and wda > 0:
            return 1 - wda ** (self.B / (cfg["epochs"]
                                         * cfg["recipe_train_sites"]))
        return cfg.get("weight_decay", 0.0)


def _site_key(pos, neg, y) -> np.ndarray:
    return ((np.asarray(pos, np.int64) * 2 + np.asarray(neg, np.int64))
            * 64 + np.asarray(y, np.int64))


def reference_follow(setup: Setup, start: Dict, first: int, n: int, dtype,
                     tf32: bool = False, fault: str = "", states=None):
    """The plain reference from ``start`` (weights, buffers and, when
    given, the optimizer's moments and step count) through the program's
    batches ``first``..``first + n - 1``, with the dropout stream at
    ``start['rng']``.  Returns (losses, the gradients the optimizer saw,
    the parameters after, rows that are no site of the benchmark's).
    ``tf32`` computes in TF32 (the control); ``fault`` plants a fault of
    the step in the reference ('half_batch'); a list ``states`` receives
    the reference's own state before each step, in ``start``'s form."""
    cfg, dev = setup.cfg, setup.device
    model = rtrain.with_mask_dropout(build_reference(cfg, setup.n_cat))
    model.load_state_dict({k: v for k, v in start["state"].items()})
    model.to(dev, dtype)
    params = dict(model.named_parameters())
    opt = rtrain.Adam(params, cfg["optim"], setup.weight_decay())
    for key, store in MOMENTS:
        for name, t in zip(setup.names, start.get("moments", {}).get(key, [])):
            getattr(opt, store)[name].copy_(t.to(dtype))
    opt.t = start.get("step", 0)
    batches, bad = [], 0
    for s in range(first, first + n):
        b, nbad = setup.batch_inputs(s, dtype)
        if fault == "half_batch":
            h = len(b[2]) // 2
            b = tuple(t[:h] for t in b)
        batches.append(b)
        bad += nbad
    lrs = [setup.lr(s) for s in range(first, first + n)]
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _set_rng_state(dev, start["rng"])
    losses = []
    try:
        for batch, lr in zip(batches, lrs):
            if states is not None:
                states.append({
                    "state": {k: v.detach().float().clone()
                              for k, v in model.state_dict().items()},
                    "moments": {key: [getattr(opt, store)[k].float().clone()
                                      for k in setup.names]
                                for key, store in MOMENTS},
                    "step": opt.t, "rng": _rng_state(dev)})
            losses += rtrain.train_steps(model, opt, [batch], [lr],
                                         loss_scale=2.0 if fault else 1.0)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    after = {k: p.detach() for k, p in params.items()}
    return losses, opt.seen, after, bad


# the program's moment lists and the reference's, by name
MOMENTS = (("exp_avg", "m"), ("exp_avg_sq", "v"), ("max_exp_avg_sq", "vmax"))


def reference_steps(setup: Setup, run: Dict, dtype=torch.float64):
    """The reference through steps 1-3 alongside ``run`` (the program's
    or the control's): step 1 from the benchmark's weights, each later
    step from ``run``'s own state before it, so that the two never drift
    apart.  Returns (losses, the first gradient its optimizer saw, the
    parameters after step 3, rows that are no site of the benchmark's)."""
    losses, bad, first_grad, after = [], 0, None, None
    for i in range(CHECK_STEPS):
        start = (run["states"][i] if i else
                 {"state": setup.init, "rng": run["states"][0]["rng"]})
        step_losses, seen, after, nbad = reference_follow(
            setup, start, i, 1, dtype)
        losses += step_losses
        bad += nbad
        if i == 0:
            first_grad = seen[0]
    return losses, first_grad, after, bad


def readings(setup: Setup, run: Dict, ref) -> Dict[str, float]:
    """The numbers of steps 1-3 that a cell compares.  ``run`` holds the
    program's (or the control's) losses of steps 1-3, the first gradient
    its optimizer saw and its parameters after step 3; ``ref`` is
    :func:`reference_steps`' result."""
    r_losses, r_grad, r_after, _ = ref
    first = {k: v.double() for k, v in r_grad.items()}
    init = {k: setup.init[k].double() for k in r_after}
    return {
        "loss_gap": max(ck.rel_gap(a, b)
                        for a, b in zip(run["losses"], r_losses)),
        "grad_median_gap": ck.median_leaf_gap(
            {k: v.double() for k, v in run["grad"].items()}, first),
        "change_median_gap": ck.median_leaf_gap(
            {k: run["after"][k].double() - init[k] for k in r_after},
            {k: r_after[k].double() - init[k] for k in r_after},
            keep=ck.moved_leaves(first)),
    }


def program_group(setup: Setup, s: int) -> Dict:
    """One group of K steps (``s``..``s + K - 1``) through the program's
    timed path, a CUDA graph replay where K > 1: the state before it, its
    losses and the parameters after it."""
    k = setup.k
    if s + k > setup.n_steps:
        raise RuntimeError(f"no group of {k} steps is left in the epoch's "
                           f"{setup.n_steps} steps")
    before = setup.snapshot()
    losses = [float(x) for x in setup.run(s, s + k)]
    after = {n: p.detach().clone()
             for n, p in setup.model.named_parameters()}
    return {"first": s, "before": before, "losses": losses, "after": after}


def control_group(setup: Setup, group: Dict, tf32: bool = True,
                  fault: str = "") -> Dict:
    """The reference in float32 put in the program's place for ``group``'s
    K steps, from the program's state before them; read as the program's
    group."""
    losses, _, after, _ = reference_follow(
        setup, group["before"], group["first"], setup.k, torch.float32,
        tf32=tf32, fault=fault)
    return {**group, "losses": losses, "after": after}


def reference_group(setup: Setup, group: Dict):
    """The float64 reference through ``group``'s K steps from the
    program's state before them."""
    return reference_follow(setup, group["before"], group["first"], setup.k,
                            torch.float64)


def group_readings(group: Dict, ref) -> Dict[str, float]:
    """``group_loss_gap``: the largest of the group's K step losses' gaps;
    ``group_change_gap``: the median leaf's gap of the change over the
    group (leaves with a reference gradient under a thousandth of the
    median leaf's left out).  A state left unchanged reads 1."""
    r_losses, seen, r_after, _ = ref
    before = {k: group["before"]["state"][k].double() for k in r_after}
    return {
        "group_loss_gap": max(ck.rel_gap(a, b)
                              for a, b in zip(group["losses"], r_losses)),
        "group_change_gap": ck.median_leaf_gap(
            {k: group["after"][k].double() - before[k] for k in r_after},
            {k: r_after[k].double() - before[k] for k in r_after},
            keep=ck.moved_leaves({k: v.double() for k, v in seen[0].items()})),
    }


def warm_up(setup: Setup, s: int) -> int:
    """One group of K captures the graph, two replay it; returns the next
    step."""
    setup.run(s, s + 3 * setup.k)
    _sync(setup.device)
    return s + 3 * setup.k


def program_first_steps(setup: Setup) -> Dict:
    """Steps 1-3 through the program, one call each: the state before
    each, their losses, the first gradient worked out from the
    optimizer's state after step 1, and the parameters after step 3."""
    from mural_tpu_torch.train.optim import BETAS
    if setup.opt.name == "SGD":
        raise ValueError("the first-gradient reading needs Adam's moments")
    states, losses = [], []
    for i in range(CHECK_STEPS):
        states.append(setup.snapshot())
        losses += [float(x) for x in setup.run(i, i + 1)]
        if i == 0:
            grad = {n: m.detach().clone() / (1 - BETAS[0])
                    for n, m in zip(setup.names,
                                    setup.opt.state["exp_avg"])}
    after = {n: p.detach().clone()
             for n, p in setup.model.named_parameters()}
    return {"losses": losses, "grad": grad, "after": after,
            "states": states}


def control_first_steps(setup: Setup, tf32: bool = True,
                        fault: str = "") -> Dict:
    """The reference put in the program's place (in TF32 for the control,
    or with a fault planted), read as :func:`program_first_steps` reads
    the program."""
    states = []
    start = {"state": setup.init, "rng": setup.snapshot()["rng"]}
    losses, seen, after, _ = reference_follow(
        setup, start, 0, CHECK_STEPS, torch.float32, tf32=tf32,
        fault=fault, states=states)
    return {"losses": losses, "grad": seen[0], "after": after,
            "states": states}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> Outcome:
    # train_trial's precision: cuDNN's and cuBLAS's TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    setup = Setup(cell, seed, device)
    B, k = setup.B, setup.k
    first = program_first_steps(setup)
    s = s0 = warm_up(setup, CHECK_STEPS)
    chunk = k * cell.traffic["window_chunk_groups"]
    tracer = Tracer() if trace else None
    losses, pending, untraced = [], None, None
    setup_s = time.time() - t_process
    t0 = time.perf_counter()
    while True:
        if s + chunk > setup.n_steps:
            raise RuntimeError(
                f"the epoch's {setup.n_steps} steps ran out before the "
                f"window closed: raise train_sites in {cell.config_name}")
        if (tracer is not None and tracer.wanted
                and time.perf_counter() - t0 > 0.4 * seconds):
            _sync(device)
            if untraced is None:
                untraced = (s - s0) * B / (time.perf_counter() - t0)
            t_begin, traced = time.perf_counter(), 0
            tracer.begin()
            while (time.perf_counter() - t_begin < tracer.length(seconds)
                   and s + chunk <= setup.n_steps):
                losses.append(setup.run(s, s + chunk))
                s += chunk
                traced += chunk
            _sync(device)
            tracer.end(units=traced)
            continue
        losses.append(setup.run(s, s + chunk))
        s += chunk
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            if pending is not None:
                pending.synchronize()
            pending = event
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    n_window = s - s0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    window_losses = torch.cat(losses).double().cpu()
    nonfinite = int((~torch.isfinite(window_losses)).sum())
    # one more group down the window's path, from a snapshot
    group = program_group(setup, s)
    # free the program's step state before the reference runs
    setup.groups = None
    ref = reference_steps(setup, first)
    found = readings(setup, first, ref)
    gref = reference_group(setup, group)
    found.update(group_readings(group, gref),
                 inputs_mismatched=float(ref[3] + gref[3]),
                 win_nonfinite=float(nonfinite))
    checks = [ck.Check(name, float(found[name]), float(limit))
              for name, limit in cell.limits.items()]
    rate = n_window * B / window_s
    return Outcome(
        setup_s=setup_s, window_s=window_s,
        rates={"train_windows_per_s": rate},
        attempted=n_window, failed=nonfinite, checks=checks,
        memory_peak_bytes=int(peak),
        stretch=tracer.stretch if tracer else None,
        facts={"kind": "train", "batch": B, "k": k,
               "rate": untraced if untraced is not None else rate,
               "readings": found})

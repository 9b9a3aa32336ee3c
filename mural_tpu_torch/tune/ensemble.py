"""Grouped execution of same-architecture trials as one vmapped ensemble
(counterpart of ``mural_tpu/tune/ensemble.py``).

The runner-side half of ``train/ensemble.py``: sampled trial configs are
grouped by signature (every config key but the ``VARY_KEYS``, which the
ensemble's step takes per member: learning rate, weight decay, the LR
schedule's constants, ``sampled_segments``), and a group of two or more
trains as one :class:`~mural_tpu_torch.train.ensemble.EnsembleState`
sharing one dataset encode and one device arena.

Each member writes its trial directory as a serial trial would
(``trial_config.pkl``, ``training.log``, ``checkpoint_<epoch>/{model,
model.config.pkl, model.fdiri_cal.pkl}`` with ``epoch_<n>_metrics.txt``,
``progress.csv``, and ``error.txt`` when its tail fails), reports each
epoch to the runner's stop rule and scheduler, and stops early on its
own.  The members' epoch tails run one after the other on a thread
while the group trains its next epoch (the serial loop's
``TailThread``), early stopping and ROP on the main thread; a member
stopped by its tail's report has trained on through the next epoch
(the live mask was set before the report) and gets that epoch's
weights back at the join, so its final weights are its last
checkpoint's.  A group
falls back to serial trials where the JAX package's does: per-base
track channels, fewer training sites than a batch, or data over the
resident budget (:func:`run_ensemble_group` returns None).

Dropout: the members draw their masks from the device generator under
``vmap(randomness="different")``, seeded with the first member's seed,
so with dropout a member's masks are not its serial trial's; at dropout
0 a member trains as its serial trial does.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# config keys that may differ inside one ensemble group (per-member
# values of the step)
VARY_KEYS = frozenset({
    "learning_rate", "weight_decay", "weight_decay_auto",
    "LR_gamma", "restart_lr", "min_lr",
    # host-side only: the order of the epoch's rows
    "sampled_segments",
})


def group_signature(config: Dict) -> Tuple:
    """Hashable signature of a trial's program: everything but
    ``VARY_KEYS``."""
    return tuple(sorted((k, repr(v)) for k, v in config.items()
                        if k not in VARY_KEYS))


def group_trials(trials: List[Tuple[str, Dict]]) -> List[List]:
    """Partition ``(trial_id, config)`` pairs into signature groups, in
    launch order inside each group."""
    groups: Dict[Tuple, List] = {}
    for t in trials:
        groups.setdefault(group_signature(t[1]), []).append(t)
    return list(groups.values())


def ensemble_eligible(config: Dict, opts) -> bool:
    """The static checks; the resident budget is checked inside
    :func:`run_ensemble_group`, which returns None to fall back."""
    return (not config.get("transfer_learning")
            and opts.model_path is None
            and opts.dp_devices <= 1
            and opts.profile_dir is None
            and opts.resident != "off")


def _member_config(cfg: Dict, opts, ds, train_size: int, epochs: int):
    """A member's config augmented as ``train_trial`` augments a serial
    trial's, so that its checkpoint pickle describes its own values."""
    from mural_tpu_torch.train.loop import trial_config
    from mural_tpu_torch.train.optim import auto_weight_decay
    c = trial_config(cfg, opts)
    c["emb_dims"] = [(x, min(16, int(x ** 0.25))) for x in ds.cat_dims]
    c["n_cont"] = ds.n_cont
    c["weight_decay"] = auto_weight_decay(
        c.get("weight_decay_auto"), c["batch_size"], epochs,
        max(train_size, 1), c.get("weight_decay", 0.0))
    return c


def run_ensemble_group(group: List[Tuple[str, Dict]], base_opts,
                       model_type: str, exp, scheduler, progress,
                       printer=print):
    """Train every trial of ``group`` as one ensemble.

    Returns ``[(trial_id, metrics or None, exception or None), ...]`` as
    the runner's serial trials do, or None when the group must fall back
    to serial trials."""
    from mural_tpu_torch.data.dataset import prepare_dataset
    from mural_tpu_torch.device import resolve_device, to_device
    from mural_tpu_torch.genome.fasta import Genome
    from mural_tpu_torch.genome.tracks import TrackSet
    from mural_tpu_torch.models.registry import build_model
    from mural_tpu_torch.train.early_stopping import EarlyStopping
    from mural_tpu_torch.train.ensemble import (EnsembleState,
                                                ensemble_batch,
                                                ensemble_epoch_scalars,
                                                ensemble_eval,
                                                ensemble_step_update)
    from mural_tpu_torch.train.graphs import StepGroups, steps_per_dispatch
    from mural_tpu_torch.train.loop import (EpochTail, TailThread,
                                            _check_classes, _softmax,
                                            check_ported, host_state,
                                            init_model, seed_device,
                                            snapshot,
                                            split_segments_like_torch,
                                            step_mode)
    from mural_tpu_torch.train.optim import LRSchedule, ReduceLROnPlateau
    from mural_tpu_torch.train.resident import (estimate_resident_bytes,
                                                make_resident,
                                                resident_epoch,
                                                stack_epoch_rows,
                                                upload_rows)
    from mural_tpu_torch.tune.runner import _keep_going
    from mural_tpu_torch.utils.params import count_parameters
    from mural_tpu_torch.utils.printer import get_printer
    from mural_tpu_torch.utils.trials import write_progress_csv

    opts = dataclasses.replace(base_opts, epochs=exp.epochs,
                               grace_period=exp.grace_period)
    check_ported(opts, model_type)
    t_start = time.time()
    arch = dict(group[0][1])           # the group's shared config
    B = arch["batch_size"]

    # --- one dataset for the group ---------------------------------------
    tracks = (TrackSet.from_list(opts.bw_paths, arch["local_radius"])
              if opts.bw_paths else None)
    if tracks is not None and not opts.without_bw_distal \
            and not opts.seq_only:
        return None                    # per-base track channels: host-fed
    genome = Genome.from_fasta(opts.ref_genome)

    def prepare(bed):
        return prepare_dataset(
            bed, genome, central_bp=arch["segment_center"],
            local_radius=arch["local_radius"],
            local_order=arch["local_order"],
            distal_radius=arch["distal_radius"],
            distal_order=opts.distal_order, model_type=model_type,
            tracks=tracks, seq_only=opts.seq_only, bw_distal=False)

    ds = prepare(opts.train_data)
    if opts.validation_data:
        ds_train, ds_valid = ds, prepare(opts.validation_data)
    else:
        # one split for the group: with --split_seed it is each serial
        # trial's; without, the group shares one random draw
        split_seed = (opts.split_seed if opts.split_seed is not None
                      else int(np.random.randint(0, 10000)))
        train_ids, valid_ids = split_segments_like_torch(
            ds.n_segments, opts.valid_ratio, split_seed)
        ds_train = ds.subset_segments(train_ids)
        ds_valid = ds.subset_segments(valid_ids)
    train_size, valid_size = ds_train.n_sites, ds_valid.n_sites
    if train_size < B:
        return None
    _check_classes(ds_train, opts.n_class, "train")
    _check_classes(ds_valid, opts.n_class, "valid")
    budget = (opts.resident_max_bytes if opts.resident_max_bytes is not None
              else int(os.environ.get("MURAL_RESIDENT_MAX_BYTES", 8 << 30)))
    if (estimate_resident_bytes(ds_train)
            + estimate_resident_bytes(ds_valid)) > budget:
        return None

    # --- the members ------------------------------------------------------
    T = len(group)
    trial_ids = [tid for tid, _ in group]
    exp_dir = os.path.join(exp.results_dir, exp.experiment_name)
    device = (torch.device(opts.device) if opts.device is not None
              else resolve_device())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    member_opts, printers, configs, seeds = [], [], [], []
    for trial_id, cfg in group:
        tdir = os.path.join(exp_dir, trial_id)
        os.makedirs(tdir, exist_ok=True)
        if os.path.exists(os.path.join(tdir, "error.txt")):
            os.remove(os.path.join(tdir, "error.txt"))
        with open(os.path.join(tdir, "trial_config.pkl"), "wb") as fh:
            pickle.dump(cfg, fh)
        seed = opts.rng_seed + int(trial_id.rsplit("_", 1)[-1])
        seeds.append(seed)
        member_opts.append(dataclasses.replace(
            opts, trial_dir=tdir,
            trial_training_log=os.path.join(tdir, "training.log"),
            rng_seed=seed))
        printers.append(get_printer(False, member_opts[-1]
                                    .trial_training_log))
        configs.append(_member_config(cfg, opts, ds, train_size,
                                      exp.epochs))
    printer(f"trial ensemble: {T} members ({', '.join(trial_ids)}) "
            f"vmapped into one step; train_size, valid_size: "
            f"{train_size}, {valid_size}")
    common = {"emb_dims": configs[0]["emb_dims"], "n_cont": ds.n_cont,
              "n_class": opts.n_class, "distal_order": opts.distal_order,
              "in_channels": 4 ** opts.distal_order}
    models = [init_model(build_model(opts.model_no, configs[t], common,
                                     model_type), ds, seeds[t])
              for t in range(T)]
    for t in range(T):
        total_params = count_parameters(models[0], printer=printers[t])
        printers[t]("train_size, valid_size:", train_size, valid_size)
        printers[t]("weight_decay:", configs[t]["weight_decay"])
    schedules = [LRSchedule.build(
        c.get("lr_scheduler", "StepLR"), c["learning_rate"],
        c.get("LR_gamma", 0.9), B, max(train_size, 1), c["restart_lr"],
        c["min_lr"]) for c in configs]
    seed_device(device, seeds[0])
    ens = EnsembleState([m.to(device) for m in models],
                        arch.get("optim", "Adam"),
                        [c["weight_decay"] for c in configs], schedules,
                        bf16=opts.bf16)
    res_train = make_resident(ds_train, device)
    res_valid = make_resident(ds_valid, device)
    k_steps = steps_per_dispatch(opts.steps_per_dispatch, model_type)
    groups = StepGroups(ens, k_steps, ensemble_batch(
        res_train, torch.ones(B, device=device)), ensemble_step_update)
    printer(f"trial ensemble: shared train arena "
            f"{res_train.arena.nbytes / 1e6:.1f} MB, valid arena "
            f"{res_valid.arena.nbytes / 1e6:.1f} MB, "
            f"{step_mode(k_steps, device)} for all {T} members")
    vrows_np, vmasks_np, v_n_valids = stack_epoch_rows(
        ds_valid, configs[0]["sampled_segments"], B, shuffle=False,
        pad_final=True)
    vrows = upload_rows(vrows_np, device)
    vmasks = torch.from_numpy(vmasks_np).to(device)
    host_rngs = [np.random.default_rng(s) for s in seeds]

    def train_rows():
        rows = np.stack([stack_epoch_rows(
            ds_train, configs[t]["sampled_segments"], B, shuffle=True,
            rng=host_rngs[t])[0] for t in range(T)], axis=1)
        return upload_rows(rows, device)           # (n_steps, T, B)

    tails = [EpochTail(member_opts[t], model_type, ds_valid, train_size,
                       total_params, printers[t]) for t in range(T)]
    es_list = [EarlyStopping(patience=opts.grace_period, verbose=True,
                             trace_func=printers[t]) for t in range(T)]
    rops = [ReduceLROnPlateau(c["learning_rate"])
            if c.get("lr_scheduler") == "ROP" else None for c in configs]
    stopped = [False] * T
    errors: List[Optional[Exception]] = [None] * T
    metrics_list: List[Dict] = [{} for _ in range(T)]
    iteration = [0] * T

    tail = TailThread()
    # the tails' copies of the members' weights to the host
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def member_tail(t, epoch, state, valid_probs, total_loss, valid_loss):
        """Member t's tail and report, in the serial tail's order; a stop
        or an error sets ``stopped[t]``."""
        p = printers[t]
        t0 = time.time()
        m, eval_s = tails[t](epoch, state, configs[t], valid_probs,
                             total_loss, valid_loss)
        metrics_list[t] = m
        iteration[t] += 1
        if progress is not None:
            progress.update(trial_ids[t], "RUNNING", iteration[t], m)
        p(f"Epoch {epoch} tail: {time.time() - t0:.3f}s on its thread "
          f"(calibration, evaluation {eval_s:.3f}s, checkpoint), "
          f"overlapping the next epoch")
        if not _keep_going(trial_ids[t], iteration[t], m, scheduler):
            p("Trial stopped by scheduler")
            stopped[t] = True

    def run_tails(epoch, live, snaps, probs, losses_np, vloss_np):
        """The tails of epoch ``epoch``'s live members, one after the
        other on the tail thread (``mural_tpu/tune/ensemble.py:
        349-418``); a member's failure is its own."""
        for t in live:
            try:
                member_tail(t, epoch, host_state(*snaps[t], copy_stream),
                            probs[t], float(losses_np[t]),
                            float(vloss_np[t]))
            except Exception as err:
                errors[t] = err
                stopped[t] = True
                with open(os.path.join(member_opts[t].trial_dir,
                                       "error.txt"), "w") as fh:
                    fh.write(traceback.format_exc())

    snaps: Dict[int, Dict] = {}
    pending_rows = train_rows()
    for epoch in range(exp.epochs):
        if all(stopped):
            break
        epoch_t = time.time()
        rows = pending_rows
        n_steps = rows.shape[0]
        losses = resident_epoch(groups, rows, to_device(
            ensemble_epoch_scalars(ens, n_steps), device)).sum(0)
        if epoch + 1 < exp.epochs:
            pending_rows = train_rows()
        losses_np = losses.cpu().numpy().astype(np.float64)
        t_train = time.time() - epoch_t
        logits, vloss = ensemble_eval(ens, res_valid, vrows, vmasks)
        vloss_np = vloss.cpu().numpy().astype(np.float64)
        lg = (logits.cpu().numpy() if logits is not None
              else np.zeros((T, 0, B, opts.n_class), np.float32))
        t_valid = time.time() - epoch_t - t_train
        # the previous epoch's tails end before these start; a member
        # its tail stopped trained through this epoch (the live mask was
        # set before its report): it gets back that epoch's weights
        tail.join()
        for t in range(T):
            if stopped[t] and t in snaps:
                ens.load_member_state(t, snaps[t][0])
        live = [t for t in range(T) if not stopped[t]]
        if not live:
            break
        snaps = {t: snapshot(ens.member_state_dict(t), device)
                 for t in live}
        probs = {t: _softmax(np.concatenate(
            [lg[t, i, :n] for i, n in enumerate(v_n_valids)])
            if v_n_valids else np.zeros((0, opts.n_class), np.float32))
            for t in live}
        for t in live:
            printers[t]("optimizer learning rate:", schedules[t].lr_at(
                ens.step, ens.epoch, ens.rop_lr[t]))
        tail.start(run_tails, epoch, live, snaps, probs, losses_np,
                   vloss_np)
        t_fetch = time.time() - epoch_t - t_train - t_valid
        # early stopping and ROP on this epoch's loss, on this thread
        for t in live:
            p = printers[t]
            current_loss = float(vloss_np[t]) / max(valid_size, 1)
            es_list[t](current_loss)
            if es_list[t].early_stop:
                p("Early stopping")
                stopped[t] = True
                continue
            if rops[t] is not None:
                ens.rop_lr[t] = rops[t].step(current_loss)
            p(f"Epoch {epoch} used time: {time.time() - epoch_t:.3f}s "
              f"(train {n_steps} steps in {t_train:.3f}s, valid "
              f"{len(v_n_valids)} batches in {t_valid:.3f}s, fetch "
              f"{t_fetch:.3f}s; calib/eval/ckpt overlap the next epoch)")
        ens.live.copy_(torch.tensor([not s for s in stopped],
                                    device=device))
        ens.epoch += 1
        printer(f"ensemble epoch {epoch}: {len(live)}/{T} members live, "
                f"train {n_steps} steps in {t_train:.3f}s "
                f"({T * n_steps * B / max(t_train, 1e-9):.0f} windows/s "
                f"for all members), valid losses "
                + " ".join(f"{v / max(valid_size, 1):.4f}"
                           for v in vloss_np))

    tail.join()
    for t in range(T):
        if stopped[t] and t in snaps:
            ens.load_member_state(t, snaps[t][0])
    results = []
    for t in range(T):
        best_epoch = metrics_list[t].get("epoch", 0) - es_list[t].counter
        printers[t](f"Best Epoch: {best_epoch}")
        printers[t](f"training finished, total time "
                    f"{time.time() - t_start:.1f}s")
        metrics_list[t]["best_epoch"] = best_epoch
        write_progress_csv(member_opts[t].trial_dir)
        results.append((trial_ids[t],
                        metrics_list[t] if errors[t] is None else None,
                        errors[t]))
    return results

"""The per-trial training pipeline (counterpart of
``mural_tpu/train/loop.py``; ref MuRaL/training.py:45-567).

track list (``--bw_paths``) -> dataset build (with the tracks' means as
continuous features and, unless ``without_bw_distal`` or ``seq_only``,
their per-base values as distal channels) -> segment-level
train/validation split (``split_seed``) -> emb_dims -> model build
(SNVNet0-3 or the INDEL U-Net) + the reference init from ``rng_seed``,
or for a transfer the checkpoint's weights with the final FC layers
re-initialised and, without ``train_all``, the rest frozen ->
weight_decay_auto -> optimizer and LR schedule -> epochs of train steps
-> per epoch: validation, FullDirichlet fit, k-mer and regional
evaluation (whose regional score is the metrics' ``score``), checkpoint
triple, ``epoch_<n>_metrics.txt``, EarlyStopping and ROP ->
``progress.csv``.

The data reach the steps one of two ways, by the JAX package's rule
(:func:`use_resident_data`): device-resident (``train/resident.py``: the
window arena and per-site arrays uploaded once per trial, one row array
per epoch, drawn and uploaded while the card runs the epoch before), or
host-fed (batches built and uploaded on a prefetch thread,
``data/prefetch.py``).  Either way the steps run K per CUDA graph replay
(``train/graphs.py``; ``steps_per_dispatch``, 8 for SNV and 1 for INDEL
by default) or, with K = 1, one eager step per batch.  ``profile_dir``
records epoch 0's train steps with torch.profiler.

The epoch tail (calibration, evaluation, checkpoint, metrics file and
the runner's report) runs on a thread while the next epoch trains
(:class:`TailThread`), in the JAX package's order: join the previous
tail, stop if it reported a stop, snapshot the weights on the device,
start the tail, then early stopping and ROP on the main thread.  The
tail copies the snapshot to the host after an event on the stream that
made it; its error is raised again at the next join.  With
``dp_devices > 1`` a trial runs as one process per device (``parallel/distributed.py spawn_ranks``): every
rank draws the same batches and takes its rows of each, its BatchNorms
reduce their statistics over the ranks (``parallel/sync_bn.py``), the
gradients are SUMmed before the clip, the losses and the validation
logits are reduced, and rank 0 alone runs the tail, writes the files and
logs; a stop from its tail reaches the others at the epoch boundary.
With
``fused_stem='on'`` each distal tower's first BN -> conv -> pool runs as
the fused stem (CUDA kernels K2/K3 on the card, see
:mod:`mural_tpu_torch.ops.fused_train_stem`) for the SNV models with
towers and no distal track channels; ``'auto'`` resolves to off, as in
the JAX package.  ``bf16`` runs every train step in mixed precision
(``train/steps.py``; the fused stem in the kernels' bf16 mode); the
validation, the epoch tail and the checkpoints stay float32.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mural_tpu_torch.calibrate.fit import calibrate_prob
from mural_tpu_torch.calibrate.poisson import poisson_calibrate
from mural_tpu_torch.data.batcher import segment_pool_batches
from mural_tpu_torch.data.cache import prepare_dataset_cached
from mural_tpu_torch.data.dataset import SiteDataset, prepare_dataset
from mural_tpu_torch.data.prefetch import (prefetch, prefetch_stacked,
                                           stacked_inputs)
from mural_tpu_torch.device import resolve_device, to_device
from mural_tpu_torch.evaluation.evaluator import Evaluator
from mural_tpu_torch.genome.fasta import Genome
from mural_tpu_torch.genome.tracks import TrackSet
from mural_tpu_torch.models.init import init_weights
from mural_tpu_torch.models.registry import build_model, check_model_no
from mural_tpu_torch.parallel.distributed import rank_context, spawn_ranks
from mural_tpu_torch.parallel.mesh import make_devices
from mural_tpu_torch.parallel.sync_bn import convert_batchnorm
from mural_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from mural_tpu_torch.train.early_stopping import EarlyStopping
from mural_tpu_torch.train.graphs import (StepGroups, epoch_scalars,
                                          host_fed_batch, steps_per_dispatch)
from mural_tpu_torch.train.optim import (GraphOptimizer, LRSchedule,
                                         ReduceLROnPlateau, auto_weight_decay)
from mural_tpu_torch.train.resident import (estimate_resident_bytes,
                                            make_resident, resident_batch,
                                            resident_epoch, resident_eval,
                                            stack_epoch_rows, upload_rows)
from mural_tpu_torch.train.steps import TrainState, eval_step, model_input
from mural_tpu_torch.utils.params import count_parameters
from mural_tpu_torch.utils.printer import get_printer
from mural_tpu_torch.utils.trials import write_progress_csv


@dataclasses.dataclass
class TrainOptions:
    """Non-searchable options (the reference's argparse ``args``)."""
    train_data: str
    ref_genome: str
    validation_data: Optional[str] = None
    bw_paths: Optional[str] = None
    distal_order: int = 1
    seq_only: bool = False
    without_bw_distal: bool = False
    n_class: int = 4
    model_no: int = 2
    epochs: int = 10
    valid_ratio: float = 0.1
    split_seed: Optional[int] = None
    save_valid_preds: bool = False
    poisson_calib: bool = False
    with_h5: bool = False              # use the on-disk site cache
    h5f_path: Optional[str] = None
    n_h5_files: int = 1                # cache shard count (parallel write)
    grace_period: int = 5
    trial_dir: str = "."
    trial_training_log: Optional[str] = None
    # transfer learning
    model_path: Optional[str] = None
    train_all: bool = True
    init_fc_with_pretrained: bool = False
    rng_seed: int = 0
    # torch device; None -> the CUDA card (RuntimeError without one)
    device: Optional[object] = None
    # data-parallel ranks, one process on each of the first dp_devices
    # devices of the device's kind (NCCL on CUDA, gloo on the CPU)
    dp_devices: int = 1
    # torch.profiler trace of epoch 0's train steps (forces K = 1)
    profile_dir: Optional[str] = None
    # bfloat16 activations in the train steps (float32 parameters,
    # optimizer, BatchNorm statistics and loss reduction)
    bf16: bool = False
    # train steps per CUDA graph replay; None -> 8 for SNV, 1 for INDEL
    steps_per_dispatch: Optional[int] = None
    # device-resident data: auto|on|off; auto -> resident when the data
    # fit resident_max_bytes and have no distal track channels
    resident: str = "auto"
    # resident budget in bytes; None -> $MURAL_RESIDENT_MAX_BYTES or 8 GiB
    resident_max_bytes: Optional[int] = None
    fused_stem: str = "auto"                   # auto|on|off; auto -> off


def check_ported(opts: TrainOptions, model_type: str = "snv") -> None:
    """Check the options before any trial starts.  Every option of the
    JAX package runs in the port; ``--model_no`` is checked here (the
    JAX package's ``ValueError``) because ``build_model`` refuses it only
    inside a trial, whose error goes to its error.txt while the run
    carries on."""
    check_model_no(opts.model_no, model_type)


def split_segments_like_torch(n_segments: int, valid_ratio: float,
                              split_seed: int):
    """Segment-level random split with ``torch.random_split`` parity
    (training.py:220-229): randperm under a manually seeded generator,
    first chunk train, second valid, valid ids sorted."""
    valid_size = int(n_segments * valid_ratio)
    train_size = n_segments - valid_size
    gen = torch.Generator().manual_seed(int(split_seed))
    perm = torch.randperm(n_segments, generator=gen).numpy()
    return (perm[:train_size],
            np.sort(perm[train_size:train_size + valid_size]))


def init_model(model: torch.nn.Module, ds: SiteDataset,
               rng_seed: int) -> torch.nn.Module:
    """The reference weight init drawn from ``rng_seed``."""
    return init_weights(model, torch.Generator().manual_seed(rng_seed))


def seed_device(device: torch.device, seed: int) -> None:
    """Seed the generator that draws dropout masks on ``device``, and no
    other: concurrent trials on other cards keep their streams.  The CPU
    generator for a CPU trial; ``cuda:idx``'s own for a CUDA trial."""
    if device.type == "cuda":
        torch.cuda.init()
        idx = (device.index if device.index is not None
               else torch.cuda.current_device())
        torch.cuda.default_generators[idx].manual_seed(seed)
    else:
        torch.default_generator.manual_seed(seed)


# the final FC layers of a transfer, the JAX package's ``local_fc``,
# ``towers/distal_fc1/fc`` and ``towers/distal_fc2/fc`` (ref
# training.py:301-321), in the order its sorted-key walk draws them;
# SNVNet0 and the U-Net have none
FINAL_FCS = ("local_fc.0", "distal_fc1.2", "distal_fc2.2")


def transfer_trainable(model: torch.nn.Module, model_type: str,
                       train_all: bool) -> List[torch.nn.Parameter]:
    """The parameters a transfer trains (training.py:301-314): all with
    ``train_all``, else the final FC layers' only.  The others keep
    ``requires_grad``: their gradients count in the clip norm, as in the
    JAX step, which masks the optimizer's update instead."""
    if train_all:
        return list(model.parameters())
    if model_type == "indel":
        raise ValueError(
            "--train_all is required for INDEL transfer learning; the "
            "INDEL model needs full fine-tuning")
    return [p for name, p in model.named_parameters()
            if name.rsplit(".", 1)[0] in FINAL_FCS]


@torch.no_grad()
def reinit_final_fcs(model: torch.nn.Module, rng_seed: int) -> None:
    """Re-initialise the final FC layers (training.py:316-321) with the
    JAX package's draws: ``normal(0, sqrt(2 / fan_in))`` of the Flax
    ``(fan_in, fan_out)`` kernel from ``default_rng(rng_seed + 12345)``,
    transposed to torch's ``(out, in)``; zero biases."""
    rng = np.random.default_rng(rng_seed + 12345)
    modules = dict(model.named_modules())
    for name in FINAL_FCS:
        if name in modules:
            fc = modules[name]
            fan_in = fc.weight.shape[1]
            fc.weight.copy_(torch.from_numpy(rng.normal(
                0, math.sqrt(2.0 / fan_in),
                size=(fan_in, fc.weight.shape[0])).T))
            fc.bias.zero_()


def _check_classes(ds: SiteDataset, n_class: int, what: str) -> None:
    """Fail fast on labels the run cannot fit: a class >= n_class, or (for
    validation) a class never observed, which the Dirichlet calibration
    needs (it fits k = the classes observed in validation)."""
    top = int(ds.y.max(initial=0))
    if top >= n_class:
        raise ValueError(f"data contains mutation class {top} but "
                         f"--n_class is {n_class}")
    if what != "valid":
        return
    seen = np.unique(ds.y)
    if len(seen) < n_class:
        missing = sorted(set(range(n_class)) - set(seen.tolist()))
        raise ValueError(
            f"validation data never shows mutation class(es) {missing} "
            f"(observed {sorted(int(c) for c in seen)}); Dirichlet "
            "calibration requires every class observed -- if the data "
            "really has fewer classes, lower --n_class; if the classes "
            "are just rare, raise --valid_ratio or try another "
            "--split_seed so the validation split samples them")


def trial_config(config: Dict, opts: TrainOptions) -> Dict:
    """A copy of a trial's config with the run's options added, as its
    checkpoint pickle records them (training.py:170-177,246-255)."""
    config = dict(config)
    config["n_class"] = opts.n_class
    config["model_no"] = opts.model_no
    config["without_bw_distal"] = opts.without_bw_distal
    config["seq_only"] = opts.seq_only
    config["restart_lr"] = config.get("restart_lr", 1e-4)
    config["min_lr"] = config.get("min_lr", 1e-6)
    return config


def _softmax(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


class EpochTail:
    """The epoch tail of one trial: calibration, evaluation, losses,
    checkpoint triple and metrics file, in the JAX package's order; it
    keeps the trial's best validation loss for ``after_min_loss``.  The
    serial loop and each member of a trial ensemble
    (``tune/ensemble.py``) run one."""

    def __init__(self, opts: TrainOptions, model_type: str,
                 ds_valid: SiteDataset, train_size: int, total_params: int,
                 printer):
        self.opts, self.model_type = opts, model_type
        self.data_local_valid = ds_valid.local_frame()
        self.chr_pos_valid = ds_valid.position_frame()
        self.train_size, self.valid_size = train_size, ds_valid.n_sites
        self.total_params = total_params
        self.printer = printer
        self.min_loss, self.min_loss_epoch, self.after_min_loss = 0.0, 0, 0

    def __call__(self, epoch: int, model, config: Dict,
                 valid_probs: np.ndarray, total_loss: float,
                 valid_total_loss: float):
        """Returns the metrics and the seconds the Evaluators took;
        ``model`` is the module or a state_dict of it."""
        opts, printer = self.opts, self.printer
        local, n_class = self.data_local_valid, opts.n_class
        train_size, valid_size = self.train_size, self.valid_size
        fdiri_cal, fdiri_nll = calibrate_prob(
            valid_probs, local["mut_type"], "FullDiri", printer=printer)
        t_eval = time.time()
        evs = [Evaluator(local, valid_probs, n_class, printer=printer),
               Evaluator(local, fdiri_cal.predict_proba(valid_probs),
                         n_class, calibra="FullDiri", printer=printer)]
        if opts.poisson_calib:
            evs.append(Evaluator(local, poisson_calibrate(valid_probs),
                                 n_class, calibra="Poisson",
                                 printer=printer))
        kmer_list = [2, 4, 6] if self.model_type == "indel" else [3, 5, 7]
        for ev in evs:
            ev.evaluate_kmer(kmer_list)
        eval_s = time.time() - t_eval
        printer("Training Loss: ", total_loss / max(train_size, 1))
        printer("Validation Loss: ", valid_total_loss / max(valid_size, 1))
        printer("Validation Loss (after fdiri_cal): ", fdiri_nll)
        t_eval = time.time()
        for ev in evs:
            ev.evaluate_regional_score(valid_size, kmer_list[:2])
        save_path = os.path.join(opts.trial_dir, f"checkpoint_{epoch}",
                                 "model")
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        evs[0].evaluate_regional_corr(
            self.chr_pos_valid, save_valid_preds=opts.save_valid_preds,
            save_path=save_path)
        for ev in evs[1:]:
            ev.evaluate_regional_corr(self.chr_pos_valid)
        eval_s += time.time() - t_eval
        save_checkpoint(save_path, model, config, fdiri_cal)
        current_loss = valid_total_loss / max(valid_size, 1)
        if epoch == 0 or current_loss < self.min_loss:
            self.min_loss, self.min_loss_epoch = current_loss, epoch
            self.after_min_loss = 0
        else:
            self.after_min_loss = epoch - self.min_loss_epoch
        m = {"loss": current_loss, "fdiri_loss": fdiri_nll,
             "after_min_loss": self.after_min_loss,
             "score": evs[0].metrics.get("score", float("nan")),
             "total_params": self.total_params, "epoch": epoch}
        with open(os.path.join(opts.trial_dir, f"checkpoint_{epoch}",
                               f"epoch_{epoch}_metrics.txt"), "w") as fh:
            for k, v in m.items():
                fh.write(f"{k}: {v}\n")
        return m, eval_s


class TailThread:
    """One epoch tail at a time on a worker thread (``mural_tpu/train/
    loop.py:599-700``).  :meth:`start` runs ``fn(*args)``; a return of
    False (a scheduler stop) or an error sets ``stop``.  :meth:`join`
    waits for the tail and raises its error on the calling thread."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.stop = False
        self.error: Optional[Exception] = None

    def start(self, fn: Callable, *args) -> None:
        def run():
            try:
                if fn(*args) is False:
                    self.stop = True
            except Exception as err:       # raised again at the join
                self.error = err
                self.stop = True

        self.thread = threading.Thread(target=run, name="mural-epoch-tail",
                                       daemon=True)
        self.thread.start()

    def join(self) -> None:
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err


def snapshot(state: Dict[str, torch.Tensor], device: torch.device):
    """A state_dict cloned on its device before the next epoch's steps
    change it, and on a card an event after the clones: ``(state, event
    or None)``."""
    snap = {k: v.detach().clone() for k, v in state.items()}
    ready = None
    if device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
    return snap, ready


def host_state(snap: Dict[str, torch.Tensor], ready, stream=None) -> Dict:
    """A :func:`snapshot` on the host.  On a card the copies run on the
    side ``stream`` after the snapshot's event, so that they do not queue
    behind the next epoch's steps on the stream that made it."""
    if ready is None:
        return snap
    stream.wait_event(ready)
    host = {}
    with torch.cuda.stream(stream):
        for k, v in snap.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return host


def use_resident_data(opts: TrainOptions, ds_train: SiteDataset,
                      ds_valid: SiteDataset, batch_size: int,
                      printer=print) -> bool:
    """The JAX package's rule (``mural_tpu/train/loop.py:474-503,
    542-557``): resident unless ``off``, distal track channels, or fewer
    sites than a batch; ``on`` then always, ``auto`` when the estimate
    fits the budget (``resident_max_bytes``, else
    ``$MURAL_RESIDENT_MAX_BYTES``, else 8 GiB).  With a validation file
    the JAX package first budgets twice the train estimate (its
    validation set is still being prepared), then the real sum, and a
    validation set over the budget falls back to host-fed batches."""
    if (opts.resident == "off" or ds_train.distal_tracks is not None
            or ds_train.n_sites < batch_size):
        return False
    if opts.resident == "on":
        return True
    budget = (opts.resident_max_bytes if opts.resident_max_bytes is not None
              else int(os.environ.get("MURAL_RESIDENT_MAX_BYTES", 8 << 30)))
    est_train = estimate_resident_bytes(ds_train)
    est = est_train + estimate_resident_bytes(ds_valid)
    if not opts.validation_data:
        return est <= budget
    if 2 * est_train > budget:
        return False
    if est > budget:
        printer(f"device-resident data: validation set exceeds the "
                f"budget ({est / 2**30:.2f} GiB > {budget / 2**30:.2f} "
                f"GiB); using host-fed batches")
        return False
    return True


def step_mode(k: int, device: torch.device) -> str:
    """How the train steps run, for the log."""
    if k == 1:
        return "one eager train step per batch"
    if device.type == "cuda":
        return f"{k} train steps per CUDA graph replay"
    return f"{k} eager train steps per group (no CUDA graphs on the CPU)"


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device: torch.device, out_dir: str) -> None:
    """Stop the profiler after the device's work and write its Chrome
    trace into ``out_dir``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          "train_epoch0.pt.trace.json"))


def train_trial(config: Dict, opts: TrainOptions, model_type: str = "snv",
                report_fn: Optional[Callable[[Dict], bool]] = None) -> Dict:
    """Run one training trial; returns the final metrics dict.

    ``report_fn(metrics) -> keep_going`` is the trial runner's hook;
    returning False stops the trial after this epoch.  A data-parallel
    trial outside a process group spawns its ranks and returns rank 0's
    metrics (:func:`spawn_dp_trial`); inside one, this is a rank."""
    check_ported(opts, model_type)
    dp = None
    if opts.dp_devices > 1:
        dp = rank_context(opts.device)
        if dp is None:
            return spawn_dp_trial(config, opts, model_type, report_fn)
    primary = dp is None or dp.primary
    printer = (get_printer(False, opts.trial_training_log) if primary
               else _silent)
    t_start = time.time()
    device = (torch.device(opts.device) if opts.device is not None
              else resolve_device())
    # the reference semantics are float32; cuDNN's TF32 default for
    # convolutions would keep only ~3 decimal digits
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # dropout draws from the device's generator (the JAX package folds
    # its dropout key per step: the two streams differ)
    seed_device(device, opts.rng_seed)
    tracks = None
    if not opts.bw_paths:
        printer("NOTE: no bigWig files provided.")
    else:
        tracks = TrackSet.from_list(opts.bw_paths, config["local_radius"])
        if tracks is None:
            printer("Warnings: no bigWig files provided in", opts.bw_paths)
    # per-base distal track channels unless --without_bw_distal or
    # --seq_only
    bw_distal = (tracks is not None and not opts.without_bw_distal
                 and not opts.seq_only)

    genome = Genome.from_fasta(opts.ref_genome)

    def prepare(bed):
        return prepare_dataset(
            bed, genome, central_bp=config["segment_center"],
            local_radius=config["local_radius"],
            local_order=config["local_order"],
            distal_radius=config["distal_radius"],
            distal_order=opts.distal_order, model_type=model_type,
            tracks=tracks, seq_only=opts.seq_only, bw_distal=bw_distal)

    step_t = time.time()
    if opts.with_h5:
        # only the training BED is cached, as in the JAX package
        ds = prepare_dataset_cached(
            opts.train_data, genome, config["segment_center"],
            config["local_radius"], config["local_order"],
            config["distal_radius"], model_type,
            cache_dir=opts.h5f_path, tracks=tracks,
            seq_only=opts.seq_only, printer=printer,
            bw_distal=bw_distal, n_files=opts.n_h5_files)
    else:
        ds = prepare(opts.train_data)
    printer("training set preprocess used time:", time.time() - step_t)
    if opts.validation_data:
        printer("using given validation file:", opts.validation_data)
        ds_train, ds_valid = ds, prepare(opts.validation_data)
    else:
        split_seed = (opts.split_seed if opts.split_seed is not None
                      else np.random.randint(0, 10000))
        train_ids, valid_ids = split_segments_like_torch(
            ds.n_segments, opts.valid_ratio, split_seed)
        ds_train = ds.subset_segments(train_ids)
        ds_valid = ds.subset_segments(valid_ids)
    train_size, valid_size = ds_train.n_sites, ds_valid.n_sites
    _check_classes(ds_train, opts.n_class, "train")
    _check_classes(ds_valid, opts.n_class, "valid")
    printer("train_size, valid_size:", train_size, valid_size)

    config = trial_config(config, opts)
    transfer = bool(config.get("transfer_learning"))
    if not transfer:
        # a transfer keeps the checkpoint's
        config["emb_dims"] = [(x, min(16, int(x ** 0.25)))
                              for x in ds.cat_dims]
    n_cont = ds.n_cont
    if (transfer and config.get("n_cont") is not None
            and config["n_cont"] != n_cont):
        raise ValueError(
            f"pretrained checkpoint used n_cont={config['n_cont']} track "
            f"feature(s) but this run provides {n_cont} -- pass the same "
            "--bw_paths track list used for pretraining")
    config["n_cont"] = n_cont    # predict and transfer rehydrate from this
    in_channels = 4 ** opts.distal_order + (n_cont if bw_distal else 0)
    common = {"emb_dims": config["emb_dims"], "n_cont": n_cont,
              "n_class": opts.n_class, "distal_order": opts.distal_order,
              "in_channels": in_channels}
    model = build_model(opts.model_no, config, common, model_type)
    # the fused stem belongs to the SNV towers on the plain one-hot (the
    # JAX package's rule, mural_tpu/train/loop.py:363-366); SNVNet0 has
    # no tower and the U-Net runs unfused
    use_fused_stem = (opts.fused_stem == "on" and model_type == "snv"
                      and opts.model_no in (1, 2, 3)
                      and in_channels == 4 and not bw_distal
                      and opts.distal_order == 1)
    if use_fused_stem:
        printer("fused train stem: on (one-hot+BN+conv+pool as the CUDA "
                "kernels K2/K3)")
    model = init_model(model, ds, opts.rng_seed)
    trainable = list(model.parameters())
    if transfer:
        config.setdefault("train_all", opts.train_all)
        config.setdefault("init_fc_with_pretrained",
                          opts.init_fc_with_pretrained)
        load_checkpoint(opts.model_path, model)
        trainable = transfer_trainable(model, model_type,
                                       config.get("train_all", True))
        if not config.get("init_fc_with_pretrained", False):
            if model_type == "indel":
                raise ValueError(
                    "--init_fc_with_pretrained is required for INDEL "
                    "transfer learning")
            reinit_final_fcs(model, opts.rng_seed)
    model = model.to(device)
    total_params = count_parameters(model, printer=printer)
    if dp is not None:
        printer(f"data-parallel training over {dp.world} devices "
                f"({dp.backend})")
        if dp.world > 1:
            convert_batchnorm(model)

    # --- optimizer / schedule -----------------------------------------
    config["weight_decay"] = auto_weight_decay(
        config.get("weight_decay_auto"), config["batch_size"],
        opts.epochs, max(train_size, 1), config.get("weight_decay", 0.0))
    printer("weight_decay:", config["weight_decay"])
    schedule = LRSchedule.build(
        config.get("lr_scheduler", "StepLR"), config["learning_rate"],
        config.get("LR_gamma", 0.9), config["batch_size"],
        max(train_size, 1), config["restart_lr"], config["min_lr"])
    # every step reads its LR from a device tensor filled once per epoch
    # (GraphOptimizer), so that K steps replay as one CUDA graph and one
    # step runs the same update.  A frozen parameter gets no optimizer
    # update, Adam's or weight decay's
    k_steps = steps_per_dispatch(opts.steps_per_dispatch, model_type,
                                 opts.profile_dir)
    state = TrainState(model, GraphOptimizer(
        config.get("optim", "Adam"), trainable, config["weight_decay"]),
        schedule, bf16=opts.bf16)
    B = config["batch_size"]
    shard = None                      # this rank's rows of each batch
    if dp is not None:
        state.grad_reduce = dp.reduce_grads
        shard = dp.shard(B)
        if dp.backend == "gloo" and device.type == "cuda" and k_steps > 1:
            raise ValueError(
                "gloo collectives on CUDA tensors cannot be captured in a "
                f"CUDA graph: run {k_steps} steps per dispatch over NCCL, "
                "or steps_per_dispatch 1")
    if opts.bf16:
        printer("mixed precision: bfloat16 activations in the train steps "
                "(float32 parameters, optimizer, BatchNorm statistics and "
                "loss reduction)")

    per = B if dp is None else B // dp.world
    resident = use_resident_data(opts, ds_train, ds_valid, B, printer)
    if resident:
        res_train = make_resident(ds_train, device)
        res_valid = make_resident(ds_valid, device)
        # validation order is fixed: its rows and masks upload once
        vrows_np, vmasks_np, v_n_valids = stack_epoch_rows(
            ds_valid, config["sampled_segments"], B, shuffle=False,
            pad_final=True)
        cols = slice(None) if shard is None else shard
        vrows = upload_rows(vrows_np[:, cols], device)
        vmasks = torch.from_numpy(
            np.ascontiguousarray(vmasks_np[:, cols])).to(device)
        printer(f"device-resident data: train arena "
                f"{res_train.arena.nbytes / 1e6:.1f} MB, valid arena "
                f"{res_valid.arena.nbytes / 1e6:.1f} MB, "
                f"{step_mode(k_steps, device)}")
        groups = StepGroups(state, k_steps, resident_batch(
            res_train, use_fused_stem, torch.ones(per, device=device)))
    else:
        printer(f"host-fed batches, {step_mode(k_steps, device)}")
        groups = StepGroups(state, k_steps, host_fed_batch(use_fused_stem))

    es = EarlyStopping(patience=opts.grace_period, verbose=True,
                       trace_func=printer)
    rop = (ReduceLROnPlateau(config["learning_rate"])
           if config.get("lr_scheduler") == "ROP" else None)
    metrics: Dict = {}
    host_rng = np.random.default_rng(opts.rng_seed)
    tail = TailThread()
    # the tail's copies of the weights to the host
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def train_rows():
        rows, _, _ = stack_epoch_rows(ds_train, config["sampled_segments"],
                                      B, shuffle=True, rng=host_rng)
        return upload_rows(rows if shard is None else rows[:, shard],
                           device)

    def host_fed_epoch():
        """One epoch of batches built on the prefetch thread, in groups of
        K; returns the loss sum on the device and the steps taken.  A stop
        reported by the previous epoch's tail ends it early (not under
        data parallelism, whose ranks must take the same steps)."""
        batches = segment_pool_batches(ds_train, config["sampled_segments"],
                                       B, shuffle=True, rng=host_rng,
                                       shard=shard)
        # the loss accumulates on the device: no host sync per step
        total = torch.zeros((), dtype=torch.float32, device=device)
        scalars = to_device(epoch_scalars(state, train_size // B), device)
        n_steps = 0
        fetch_t = train_t = 0.0
        t0 = time.time()
        for db in (prefetch(batches, device) if k_steps == 1
                   else prefetch_stacked(batches, k_steps, device)):
            if tail.stop and dp is None:
                break
            t1 = time.time()
            fetch_t += t1 - t0
            inputs = stacked_inputs(db)
            k = inputs[0].shape[0]
            total += groups.run(scalars[n_steps:n_steps + k], inputs).sum()
            n_steps += k
            t0 = time.time()
            train_t += t0 - t1
            if n_steps % 1000 < k and n_steps >= 1000:
                printer(f"Batch {n_steps}: fetch {fetch_t:.1f}s, "
                        f"train {train_t:.1f}s (last 1000, async)")
                fetch_t = train_t = 0.0
        return total, n_steps

    def host_fed_valid():
        """Validation batches built on the prefetch thread: (logits of
        the real rows, loss sum on the device, batches).  Under data
        parallelism each rank runs its rows of each padded batch and the
        logits and masks are summed into whole batches on every rank."""
        total = torch.zeros((), dtype=torch.float32, device=device)
        parts: List[torch.Tensor] = []
        masks: List[torch.Tensor] = []
        for db in prefetch(segment_pool_batches(
                ds_valid, config["sampled_segments"], B, shuffle=False,
                pad_final=True, shard=shard), device):
            logits, vloss = eval_step(
                model, db.y, db.cat,
                model_input(db.distal, use_fused_stem, db.distal_tracks),
                db.mask, db.cont)
            total += vloss
            parts.append(logits if dp is not None else logits[:db.n_valid])
            masks.append(db.mask)
        if dp is not None and parts:
            logits = dp.gather_rows(torch.stack(parts), B)
            parts = [logits[dp.gather_rows(torch.stack(masks), B) > 0]]
        valid_logits = (torch.cat(parts).cpu().numpy() if parts
                        else np.zeros((0, opts.n_class), np.float32))
        return valid_logits, total, len(masks)

    epoch_tail = EpochTail(opts, model_type, ds_valid, train_size,
                           total_params, printer)

    def run_tail(epoch, snap, ready, valid_logits, total_loss,
                 valid_total_loss):
        """The tail thread's job: the snapshot to the host, then the
        epoch tail and the runner's report; False stops the trial."""
        nonlocal metrics
        t0 = time.time()
        m, eval_s = epoch_tail(epoch, host_state(snap, ready, copy_stream),
                               config, _softmax(valid_logits), total_loss,
                               valid_total_loss)
        metrics = m
        printer(f"Epoch {epoch} tail: {time.time() - t0:.3f}s on its "
                f"thread (calibration, evaluation {eval_s:.3f}s, "
                f"checkpoint), overlapping the next epoch")
        if report_fn is not None and report_fn(m) is False:
            printer("Trial stopped by scheduler")
            return False
        return True

    # the first epoch's rows; each later epoch's are drawn and uploaded
    # while the card runs the epoch before
    pending_rows = train_rows() if resident else None
    for epoch in range(opts.epochs):
        if tail.stop and dp is None:
            # the previous tail reported a stop: no epoch is dispatched
            # (ranks of a data-parallel trial stop at the boundary below)
            break
        epoch_t = time.time()
        prof = (_start_profiler(device) if primary and epoch == 0
                and opts.profile_dir is not None else None)
        if resident:
            rows = pending_rows
            n_steps = rows.shape[0]
            losses = resident_epoch(groups, rows, to_device(
                epoch_scalars(state, n_steps), device))
            total_loss_dev = (losses if dp is None
                              else dp.all_reduce_(losses)).sum()
            if epoch + 1 < opts.epochs:
                pending_rows = train_rows()
        else:
            total_loss_dev, n_steps = host_fed_epoch()
            if dp is not None:
                dp.all_reduce_(total_loss_dev)
        if prof is not None:
            _stop_profiler(prof, device, opts.profile_dir)
            printer("profiler trace written to", opts.profile_dir)
        total_loss = float(total_loss_dev)
        t_train_done = time.time()
        printer("optimizer learning rate:", state.lr())

        # ---- validation ----------------------------------------------
        if resident:
            logits, vloss_dev = resident_eval(model, res_valid, vrows,
                                              vmasks, use_fused_stem)
            n_valid_batches = len(v_n_valids)
            if dp is not None and logits is not None:
                logits = dp.gather_rows(logits, B)
            lg = (logits.cpu().numpy() if logits is not None
                  else np.zeros((0, B, opts.n_class), np.float32))
            valid_logits = (np.concatenate([lg[i, :n] for i, n in
                                            enumerate(v_n_valids)])
                            if v_n_valids
                            else np.zeros((0, opts.n_class), np.float32))
        else:
            valid_logits, vloss_dev, n_valid_batches = host_fed_valid()
        if dp is not None:
            dp.all_reduce_(vloss_dev)
        valid_total_loss = float(vloss_dev)
        t_valid_done = time.time()

        # the previous epoch's tail ends before this one's starts
        tail.join()
        stop = tail.stop
        if dp is not None:
            stop = bool(dp.broadcast_flag(int(stop)))
        if stop:
            break
        if primary:
            snap, ready = snapshot(model.state_dict(), device)
            tail.start(run_tail, epoch, snap, ready, valid_logits,
                       total_loss, valid_total_loss)
        t_fetch_done = time.time()
        current_loss = valid_total_loss / max(valid_size, 1)
        es(current_loss)
        if es.early_stop:
            printer("Early stopping")
            break
        if rop is not None:
            state.rop_lr = rop.step(current_loss)
        state.epoch += 1
        now = time.time()
        printer(f"Epoch {epoch} used time: {now - epoch_t:.3f}s "
                f"(train {n_steps} steps in {t_train_done - epoch_t:.3f}s, "
                f"valid {n_valid_batches} batches in "
                f"{t_valid_done - t_train_done:.3f}s, fetch "
                f"{t_fetch_done - t_valid_done:.3f}s; calib/eval/ckpt "
                f"overlap the next epoch)")
        sys.stdout.flush()

    tail.join()
    best_epoch = metrics.get("epoch", 0) - es.counter
    printer(f"Best Epoch: {best_epoch}")
    printer(f"training finished, total time {time.time() - t_start:.1f}s")
    metrics["best_epoch"] = best_epoch
    if primary:
        write_progress_csv(opts.trial_dir)
    return metrics


def _silent(*args, **kwargs) -> None:
    """The printer of a data-parallel rank other than 0."""


def _dp_rank_trial(ctx, config: Dict, opts: TrainOptions,
                   model_type: str) -> Dict:
    """A data-parallel rank's body (:func:`spawn_dp_trial`)."""
    return train_trial(config, dataclasses.replace(opts, device=ctx.device),
                       model_type, report_fn=ctx.report)


def spawn_dp_trial(config: Dict, opts: TrainOptions, model_type: str,
                   report_fn: Optional[Callable] = None) -> Dict:
    """Run a data-parallel trial as one spawned rank per device and
    return rank 0's metrics; rank 0's reports reach ``report_fn``.
    Raises the JAX package's errors for a batch that does not split and
    for more devices than there are (``requested N devices, have M``)."""
    devices = make_devices(opts.dp_devices, opts.device
                           if opts.device is not None else resolve_device())
    if config["batch_size"] % len(devices):
        raise ValueError(f"batch_size {config['batch_size']} must be "
                         f"divisible by dp_devices {len(devices)}")
    # every rank draws the same split
    split_seed = (opts.split_seed if opts.split_seed is not None
                  else int(np.random.randint(0, 10000)))
    return spawn_ranks(_dp_rank_trial, devices, (
        config, dataclasses.replace(opts, split_seed=split_seed),
        model_type), report_fn=report_fn)[0]

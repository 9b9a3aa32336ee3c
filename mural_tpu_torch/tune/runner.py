"""Experiment runner: trials across CUDA devices, ASHA early stopping
(counterpart of ``mural_tpu/tune/runner.py``).

Replaces both of the reference's execution modes:

- standalone serial trials (``run_standalong_training``,
  MuRaL/utils/train_utils.py:47-82) -> ``n_parallel=1``;
- Ray Tune's fractional-GPU trial packing (run_train_raytune.py:303-315)
  -> one trial per CUDA device at a time, each in a worker thread whose
  current device is its own (``torch.cuda.device``), or in a spawned
  process (``trial_executor='process'``).

Each trial gets the id ``Train_<5char>_<idx>`` from
``random.Random(seed)``, the directory ``results/<experiment>/<trial>/``,
its config pickled there at launch and its own init/shuffle seed
``rng_seed + idx``.  A trial that raises leaves ``error.txt`` and the run
carries on; ``rerun_failed`` re-runs only the trials that have one, each
from its own pickled config (the reference's ``resume='ERRORED_ONLY'``,
run_train_raytune.py:233-236,314).  A trial whose validation loss has
not improved for ``AFTER_MIN_LOSS_STOP`` epochs stops (``stop=
{'after_min_loss': 3}``, :308), then the ASHA scheduler decides.  With
``ensemble='auto'`` same-signature groups of two or more trials first
train as vmapped ensembles (``tune/ensemble.py``), one group per device
at a time; the groups that fall back and the other trials then run as
above.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import random
import threading
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mural_tpu_torch.train.loop import TrainOptions, train_trial
from mural_tpu_torch.tune.asha import ASHAScheduler
from mural_tpu_torch.tune.space import sample_config
from mural_tpu_torch.utils.params import format_table
from mural_tpu_torch.utils.trials import (generate_trial_id,
                                          scan_experiment_best,
                                          write_progress_csv)

AFTER_MIN_LOSS_STOP = 3


@dataclasses.dataclass
class ExperimentOptions:
    experiment_name: str
    results_dir: str = "./results"
    n_trials: int = 2
    epochs: int = 10
    grace_period: int = 5
    asha_metric: str = "loss"
    use_scheduler: bool = False       # the reference's --use_ray
    n_parallel: int = 1               # trials run concurrently (devices)
    rerun_failed: bool = False
    seed: Optional[int] = None
    progress_interval: float = 30.0   # live table cadence (scheduler mode)
    trial_executor: str = "thread"    # 'thread' | 'process'
    ensemble: str = "off"             # 'auto': vmapped trial ensembles


class ProgressTable:
    """Live trial-status table (the reference's Ray CLIReporter,
    run_train_raytune.py:294): a daemon thread prints every trial's
    latest metrics each ``interval`` seconds while trials run, and once
    more at the end."""

    COLS = ["trial", "status", "iter", "loss", "fdiri_loss",
            "after_min_loss"]

    def __init__(self, printer=print, interval: float = 30.0):
        self.printer = printer
        self.interval = interval
        self._rows: Dict[str, Dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def update(self, trial_id: str, status: str, iteration: int = 0,
               metrics: Optional[Dict] = None) -> None:
        with self._lock:
            row = self._rows.setdefault(trial_id, {})
            row["status"] = status
            if iteration:
                row["iter"] = iteration
            if metrics:
                row.update({k: metrics[k] for k in
                            ("loss", "fdiri_loss", "after_min_loss")
                            if k in metrics})

    def render(self) -> str:
        rows = []
        with self._lock:
            for trial_id in sorted(self._rows):
                row = self._rows[trial_id]
                rows.append([trial_id, row.get("status", "?"),
                             row.get("iter", 0)]
                            + [(f"{row[k]:.5g}" if k in row else "-")
                               for k in ("loss", "fdiri_loss")]
                            + [row.get("after_min_loss", "-")])
        return format_table(self.COLS, rows)

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.printer(self.render())

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        self.printer(self.render())


def _keep_going(trial_id: str, iteration: int, metrics: Dict,
                scheduler) -> bool:
    """The stop rule, then the scheduler's verdict."""
    if metrics.get("after_min_loss", 0) >= AFTER_MIN_LOSS_STOP:
        return False
    if scheduler is not None:
        return scheduler.on_report(trial_id, iteration, metrics)
    return True


def _write_error(trial_dir: str, text: str) -> None:
    os.makedirs(trial_dir, exist_ok=True)
    with open(os.path.join(trial_dir, "error.txt"), "w") as fh:
        fh.write(text)


def _trial_worker(trial_id: str, config: Dict, opts: TrainOptions,
                  model_type: str, scheduler,
                  progress: Optional[ProgressTable] = None):
    """One trial on ``opts.device``; returns (trial_id, metrics or None,
    exception or None)."""
    iteration = {"n": 0}

    def report(metrics: Dict) -> bool:
        iteration["n"] += 1
        if progress is not None:
            progress.update(trial_id, "RUNNING", iteration["n"], metrics)
        return _keep_going(trial_id, iteration["n"], metrics, scheduler)

    try:
        device = torch.device(opts.device) if opts.device is not None \
            else None
        if device is not None and device.type == "cuda" \
                and device.index is not None:
            # kernels launch on the calling thread's current device
            with torch.cuda.device(device):
                metrics = train_trial(config, opts, model_type,
                                      report_fn=report)
        else:
            metrics = train_trial(config, opts, model_type,
                                  report_fn=report)
        return trial_id, metrics, None
    except Exception as err:  # recorded for rerun_failed
        _write_error(opts.trial_dir, traceback.format_exc())
        return trial_id, None, err


class _SchedulerBridge:
    """Child-process side of the trial <-> scheduler protocol: sends each
    epoch report over the pipe and waits for the parent's verdict (the
    parent owns the real ASHAScheduler, so its promotions see every
    trial's reports)."""

    def __init__(self, conn):
        self.conn = conn

    def on_report(self, trial_id, iteration, metrics) -> bool:
        self.conn.send(("report", iteration, metrics))
        return bool(self.conn.recv())


def _process_entry(conn, trial_id, config, opts, model_type,
                   device_index, n_parallel, n_threads):
    """Spawned-process trial body.  A CUDA run takes device
    ``cuda:(launch_idx % n_parallel)`` when trials run concurrently, as
    the threaded executor does, else the parent's device; it raises when
    the child sees no card.  A CPU run stays on the CPU with the parent's
    intra-op thread count."""
    try:
        torch.set_num_threads(n_threads)
        base = torch.device(opts.device if opts.device is not None
                            else "cuda")
        if base.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("trial process: no CUDA device is "
                                   "available for a CUDA run")
            if n_parallel > 1:
                opts = dataclasses.replace(
                    opts, device=torch.device(
                        f"cuda:{device_index % n_parallel}"))
        out = _trial_worker(trial_id, config, opts, model_type,
                            _SchedulerBridge(conn))
        conn.send(("done", out[1],
                   None if out[2] is None else repr(out[2])))
    except BaseException as err:   # never leave the parent waiting
        try:
            conn.send(("done", None, repr(err)))
        except OSError:
            pass
        raise
    finally:
        conn.close()


def _run_trial_in_process(trial_id, config, opts, model_type, scheduler,
                          device_index, n_parallel, progress):
    """Parent side: spawn the trial, then serve scheduler verdicts until
    it is done."""
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(
        target=_process_entry,
        args=(child, trial_id, config, opts, model_type, device_index,
              n_parallel, torch.get_num_threads()),
        daemon=False)
    proc.start()
    child.close()
    metrics, err_repr = None, None
    try:
        while True:
            try:
                msg = parent.recv()
            except EOFError:        # the child died without 'done'
                err_repr = "trial process exited unexpectedly"
                break
            if msg[0] == "report":
                _, iteration, m = msg
                if progress is not None:
                    progress.update(trial_id, "RUNNING", iteration, m)
                parent.send(_keep_going(trial_id, iteration, m, scheduler))
            else:                   # ("done", metrics, err_repr)
                _, metrics, err_repr = msg
                break
    finally:
        # an exception above would leave the child waiting on its pipe
        if proc.is_alive() and err_repr is None and metrics is None:
            proc.terminate()
        proc.join()
        parent.close()
    err = RuntimeError(err_repr) if err_repr is not None else None
    if err is not None and metrics is None and not os.path.exists(
            os.path.join(opts.trial_dir, "error.txt")):
        # rerun_failed must see a child that died before it could write
        _write_error(opts.trial_dir, str(err_repr) + "\n")
    return trial_id, metrics, err


def trial_devices(base_device) -> List[torch.device]:
    """The devices trials are spread over: every CUDA device when the
    base device is CUDA, else the one CPU."""
    base = torch.device(base_device if base_device is not None else "cuda")
    if base.type == "cuda":
        return [torch.device(f"cuda:{i}")
                for i in range(torch.cuda.device_count())]
    return [base]


def _trials(space: Dict, exp: ExperimentOptions, exp_dir: str,
            rng: np.random.Generator, printer) -> List:
    """[(trial_id, config)]: fresh samples, or the errored trials of an
    earlier run, each with the config pickled at its launch."""
    if not exp.rerun_failed:
        id_rng = random.Random(exp.seed)
        return [(generate_trial_id(i, id_rng), sample_config(space, rng))
                for i in range(exp.n_trials)]
    trials = []
    for name in sorted(os.listdir(exp_dir)):
        tdir = os.path.join(exp_dir, name)
        if os.path.isdir(tdir) and os.path.exists(
                os.path.join(tdir, "error.txt")):
            cfg_path = os.path.join(tdir, "trial_config.pkl")
            if os.path.exists(cfg_path):
                with open(cfg_path, "rb") as fh:
                    trials.append((name, pickle.load(fh)))
            else:
                trials.append((name, sample_config(space, rng)))
    printer(f"rerun_failed: re-running {len(trials)} errored trials")
    return trials


def _run_ensembles(trials, base_opts, model_type, exp, scheduler, progress,
                   printer, devices, n_parallel, exp_dir) -> List:
    """Train the same-signature groups of two or more eligible trials as
    ensembles (``mural_tpu/tune/runner.py:329-395``): with ``n_parallel
    > 1`` and several groups, one group per device in threads.  Returns
    the trials left for the serial executors: the groups that fell back,
    then the others."""
    from mural_tpu_torch.tune.ensemble import (ensemble_eligible,
                                               group_trials,
                                               run_ensemble_group)
    remaining: List = []
    lock = threading.Lock()

    def run_group(group, device):
        opts = (dataclasses.replace(base_opts, device=device)
                if device is not None else base_opts)
        if progress is not None:
            for tid, _ in group:
                progress.update(tid, "RUNNING")
        try:
            if device is not None and torch.device(device).type == "cuda":
                with torch.cuda.device(device):
                    out = run_ensemble_group(group, opts, model_type, exp,
                                             scheduler, progress, printer)
            else:
                out = run_ensemble_group(group, opts, model_type, exp,
                                         scheduler, progress, printer)
        except Exception as err:       # a failure of the whole group
            text = traceback.format_exc()
            out = []
            for tid, _ in group:
                _write_error(os.path.join(exp_dir, tid), text)
                out.append((tid, None, err))
        if out is None:                # fall back to serial trials
            with lock:
                remaining.extend(group)
            return
        for tid, metrics, err in out:
            if progress is not None:
                progress.update(tid, "ERROR" if err is not None
                                else "TERMINATED")
            if err is not None:
                printer(f"Trial {tid} FAILED: {err}")
            else:
                printer(f"Trial {tid} finished: loss="
                        f"{metrics.get('loss'):.6g}")

    groups, singles = [], []
    for group in group_trials(trials):
        if len(group) >= 2 and ensemble_eligible(group[0][1], base_opts):
            groups.append(group)
        else:
            singles.extend(group)
    if n_parallel > 1 and len(groups) > 1:
        sem = threading.Semaphore(n_parallel)

        def guarded(i, group):
            with sem:
                run_group(group, devices[i % n_parallel])

        threads = [threading.Thread(target=guarded, args=(i, g))
                   for i, g in enumerate(groups)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    else:
        for group in groups:
            run_group(group, None)
    return remaining + singles


def run_experiment(space: Dict, base_opts: TrainOptions, model_type: str,
                   exp: ExperimentOptions, printer: Callable = print,
                   devices: Optional[Sequence] = None) -> List:
    """Sample and run ``n_trials`` configs of ``space`` (a plain dict in
    standalone mode).  Returns the sorted best-model list
    [(checkpoint_path, loss), ...].  ``devices`` overrides
    :func:`trial_devices` (tests spread threads over CPU "devices")."""
    exp_dir = os.path.join(exp.results_dir, exp.experiment_name)
    os.makedirs(exp_dir, exist_ok=True)
    rng = np.random.default_rng(exp.seed)

    scheduler = progress = None
    if exp.use_scheduler:
        scheduler = ASHAScheduler(metric=exp.asha_metric, mode="min",
                                  max_t=exp.epochs,
                                  grace_period=exp.grace_period)
        progress = ProgressTable(printer=printer,
                                 interval=exp.progress_interval)
        progress.start()

    trials = _trials(space, exp, exp_dir, rng, printer)
    devices = list(devices) if devices is not None else trial_devices(
        base_opts.device)
    n_parallel = min(max(exp.n_parallel, 1), max(len(devices), 1))
    lock = threading.Lock()
    launch_counter = [0]

    def launch(trial_id, config):
        trial_dir = os.path.join(exp_dir, trial_id)
        os.makedirs(trial_dir, exist_ok=True)
        err_path = os.path.join(trial_dir, "error.txt")
        if os.path.exists(err_path):
            os.remove(err_path)
        # every trial gets its own init/shuffle seed: repeats of one
        # config would otherwise be bit-identical
        opts = dataclasses.replace(
            base_opts, trial_dir=trial_dir,
            trial_training_log=os.path.join(trial_dir, "training.log"),
            epochs=exp.epochs, grace_period=exp.grace_period,
            rng_seed=base_opts.rng_seed + int(trial_id.rsplit("_", 1)[-1]))
        with lock:
            launch_idx = launch_counter[0]
            launch_counter[0] += 1
        if n_parallel > 1:
            # round-robin over launch order (the count of finished trials
            # would pin all concurrent starters to device 0)
            opts = dataclasses.replace(
                opts, device=devices[launch_idx % n_parallel])
        with open(os.path.join(trial_dir, "trial_config.pkl"), "wb") as fh:
            pickle.dump(config, fh)
        if progress is not None:
            progress.update(trial_id, "RUNNING")
        if exp.trial_executor == "process":
            out = _run_trial_in_process(trial_id, config, opts, model_type,
                                        scheduler, launch_idx, n_parallel,
                                        progress)
        else:
            out = _trial_worker(trial_id, config, opts, model_type,
                                scheduler, progress)
        write_progress_csv(trial_dir)
        status = "ERROR" if out[2] is not None else "TERMINATED"
        if progress is not None:
            progress.update(trial_id, status)
        if out[2] is not None:
            printer(f"Trial {trial_id} FAILED: {out[2]}")
        else:
            printer(f"Trial {trial_id} finished: loss="
                    f"{out[1].get('loss'):.6g}")

    if exp.ensemble == "auto" and len(trials) >= 2:
        trials = _run_ensembles(trials, base_opts, model_type, exp,
                                scheduler, progress, printer, devices,
                                n_parallel, exp_dir)

    if n_parallel <= 1:
        for t in trials:
            launch(*t)
    else:
        sem = threading.Semaphore(n_parallel)

        def guarded(t):
            with sem:
                launch(*t)

        threads = [threading.Thread(target=guarded, args=(t,))
                   for t in trials]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    if progress is not None:
        progress.stop()
    best = scan_experiment_best(exp_dir, metric="loss")
    if best:
        printer("Best checkpoints by validation loss:")
        for path, loss in best[:10]:
            printer(f"  {loss:.6g}  {path}")
        with open(os.path.join(exp_dir, "best_models.txt"), "w") as fh:
            for path, loss in best:
                fh.write(f"{loss}\t{path}\n")
    return best

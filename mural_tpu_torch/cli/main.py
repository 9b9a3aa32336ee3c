"""CLI dispatch for mural_snv and mural_indel (counterpart of
``mural_tpu/cli/main.py``).

``train`` (standalone trials, or an ASHA-scheduled search with
``--use_ray``, on one or several devices, in threads or processes),
``transfer``, ``predict``, ``predict_genome``, ``evaluate``, ``scale``,
``calc_scaling_factor``, ``get_best_model`` and ``convert``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from mural_tpu_torch.cli import commands as C
from mural_tpu_torch.tune.space import (Choice, SampleFrom,
                                        loguniform_or_choice)


def create_parser(model_type: str) -> argparse.ArgumentParser:
    prog = f"mural_{model_type}"
    parser = argparse.ArgumentParser(
        prog=prog,
        description=f"{prog}: germline "
                    f"{'SNV' if model_type == 'snv' else 'INDEL'} "
                    "mutation rate estimation on PyTorch/CUDA",
        formatter_class=argparse.RawTextHelpFormatter)
    sub = parser.add_subparsers(dest="command")
    C.add_train_parser(sub, model_type)
    C.add_transfer_parser(sub, model_type)
    C.add_predict_parser(sub, model_type)
    C.add_predict_genome_parser(sub, model_type)
    C.add_evaluate_parser(sub, model_type)
    C.add_scale_parser(sub, model_type)
    C.add_calc_scaling_factor_parser(sub, model_type)
    C.add_get_best_model_parser(sub, model_type)
    C.add_convert_parser(sub, model_type)
    return parser


def _abspath(p):
    return os.path.abspath(p) if p else p


def _build_space(args, model_type: str) -> dict:
    """The trial config of ``train``: the first value of each list flag
    (standalone), or with ``--use_ray`` a search space over the lists
    (``mural_tpu/cli/main.py:45-137``; ref run_train_raytune.py:186-282).
    The INDEL keys are fixed: the U-Net reads only the distal window, and
    the local columns feed the k-mer evaluation."""
    if not args.use_ray:
        first = lambda values: values[0]     # noqa: E731
        lr_or_wd = first
    else:
        first = Choice
        lr_or_wd = loguniform_or_choice
    config = {
        "segment_center": args.segment_center,
        "distal_radius": first(args.distal_radius),
        "CNN_kernel_size": first(args.CNN_kernel_size),
        "CNN_out_channels": first(args.CNN_out_channels),
        "batch_size": first(args.batch_size),
        "sampled_segments": first(args.sampled_segments),
        "learning_rate": lr_or_wd(args.learning_rate),
        "optim": first(args.optim),
        "lr_scheduler": first(args.lr_scheduler),
        "LR_gamma": first(args.LR_gamma),
        "weight_decay": lr_or_wd(args.weight_decay),
        "weight_decay_auto": args.weight_decay_auto,
        "restart_lr": args.restart_lr,
        "min_lr": args.min_lr,
        "transfer_learning": False,
    }
    if model_type == "snv":
        if not args.use_ray:
            h2 = args.local_hidden2_size[0]
            hidden2 = h2 if h2 > 0 else args.local_hidden1_size[0] // 2
        elif max(args.local_hidden2_size) > 0:
            hidden2 = Choice(args.local_hidden2_size)
        else:
            hidden2 = SampleFrom(_half_hidden1)
        config.update({
            "local_radius": first(args.local_radius),
            "local_order": first(args.local_order),
            "local_hidden1_size": first(args.local_hidden1_size),
            "local_hidden2_size": hidden2,
            "emb_dropout": first(args.emb_dropout),
            "distal_fc_dropout": first(args.distal_fc_dropout),
            "local_dropout": first(args.local_dropout),
        })
    else:
        config.update({
            "local_radius": 6,
            "local_order": 1,
            "local_hidden1_size": None,
            "local_hidden2_size": None,
            "emb_dropout": None,
            "distal_fc_dropout": None,
            "local_dropout": None,
            "use_reverse": args.use_reverse,
            "down_list": args.down_list,
        })
    return config


def _half_hidden1(config: dict) -> int:
    """``local_hidden2_size`` 0 in search mode: half the sampled
    ``local_hidden1_size``."""
    return config["local_hidden1_size"] // 2


def _train_opts(args, model_type: str):
    """The trial runner's non-searchable options of train and transfer,
    without the device."""
    from mural_tpu_torch.train.loop import TrainOptions
    if args.sample_weights:
        print("Warning: sample_weights be dropped, the program will "
              "run with sample_weights=None!")
    return TrainOptions(
        train_data=_abspath(args.train_data),
        ref_genome=_abspath(args.ref_genome),
        validation_data=_abspath(args.validation_data),
        bw_paths=_abspath(args.bw_paths),
        distal_order=getattr(args, "distal_order", 1),
        seq_only=args.seq_only,
        without_bw_distal=args.without_bw_distal,
        n_class=args.n_class,
        model_no=getattr(args, "model_no", 0),
        epochs=args.epochs,
        valid_ratio=args.valid_ratio,
        split_seed=(args.split_seed if args.split_seed >= 0 else None),
        save_valid_preds=args.save_valid_preds,
        poisson_calib=args.poisson_calib,
        with_h5=args.with_h5,
        h5f_path=args.h5f_path,
        n_h5_files=args.n_h5_files,
        grace_period=args.grace_period,
        dp_devices=args.dp_devices,
        profile_dir=args.profile_dir,
        bf16=args.bf16,
        steps_per_dispatch=args.steps_per_dispatch,
        resident=args.resident_data,
        fused_stem=args.fused_stem,
    )


def _experiment(args, **extra):
    from mural_tpu_torch.tune.runner import ExperimentOptions
    return ExperimentOptions(
        experiment_name=args.experiment_name, n_trials=args.n_trials,
        epochs=args.epochs, grace_period=args.grace_period,
        asha_metric=args.ASHA_metric, use_scheduler=args.use_ray,
        n_parallel=args.n_parallel, rerun_failed=args.rerun_failed,
        trial_executor=args.trial_executor, **extra)


def _advise_indel_throughput(args, model_type: str) -> None:
    """The JAX CLI's throughput note for INDEL (``mural_tpu/cli/
    main.py:174-195``), with the same triggers; where that note gives
    the TPU's speed-up of ``--bf16``, this one gives the factor that
    ``chip_smoke.py`` phase 15 measured on the card (PERF.md): on the
    H100 the U-Net's step takes the same device time in bf16, so
    ``--bf16`` is no faster there.  Batches below 128 leave the card
    underused.  The defaults stay the reference's (float32, batch
    128)."""
    if model_type != "indel":
        return
    hints = []
    if not args.bf16:
        hints.append("--bf16 (bf16 activations; f32 optimizer/BN stats/"
                     "loss; losses track f32 closely) trained this model "
                     "at 0.76-0.87x the float32 windows/s on an NVIDIA "
                     "H100 80GB HBM3 at 700 W")
    if args.batch_size and max(args.batch_size) < 128:
        hints.append(f"batch_size {max(args.batch_size)} leaves the card "
                     "half dispatch-bound; >=128 saturates it")
    if hints:
        print("Throughput note: " + "; ".join(hints) + ".")


def cmd_train(args, model_type: str) -> int:
    from mural_tpu_torch.device import resolve_device
    from mural_tpu_torch.parallel.mesh import make_devices
    from mural_tpu_torch.train.loop import check_ported
    from mural_tpu_torch.tune.runner import run_experiment
    _advise_indel_throughput(args, model_type)
    space = _build_space(args, model_type)
    opts = _train_opts(args, model_type)
    # fail before any trial starts: a trial's own error goes to its
    # error.txt and the run carries on
    check_ported(opts, model_type)
    opts.device = resolve_device(args.cpu_only, args.cuda_id)
    if opts.dp_devices > 1:         # "requested N devices, have M"
        make_devices(opts.dp_devices, opts.device)
    run_experiment(space, opts, model_type,
                   _experiment(args, ensemble=args.trial_ensemble))
    return 0


def cmd_transfer(args, model_type: str) -> int:
    """``mural_tpu/cli/main.py:219-285`` (ref run_train_TL_raytune.py:
    52-337): the architecture comes from the checkpoint's config, the
    learning parameters from the flags (their first values, or a search
    space under ``--use_ray``)."""
    from mural_tpu_torch.device import resolve_device
    from mural_tpu_torch.train.checkpoint import load_config
    from mural_tpu_torch.train.loop import check_ported
    from mural_tpu_torch.tune.runner import run_experiment
    opts = _train_opts(args, model_type)
    opts.device = resolve_device(args.cpu_only, args.cuda_id)
    if not args.train_all:
        print(f"Warning: --train_all is required for {model_type} "
              "transfer learning! Setting it to True.")
        args.train_all = True

    saved = load_config(_abspath(args.model_config_path))
    config = dict(saved)
    config["transfer_learning"] = True
    config["train_all"] = args.train_all
    config["init_fc_with_pretrained"] = args.init_fc_with_pretrained
    if args.use_ray:
        # choice over batch_size/optim/lr_scheduler/LR_gamma, log-uniform
        # over learning_rate/weight_decay (run_train_TL_raytune.py:
        # 276-303); the architecture stays the checkpoint's
        config["batch_size"] = Choice(args.batch_size)
        config["optim"] = Choice(args.optim)
        config["learning_rate"] = loguniform_or_choice(args.learning_rate)
        config["lr_scheduler"] = Choice(args.lr_scheduler)
        config["LR_gamma"] = Choice(args.LR_gamma)
        config["weight_decay"] = loguniform_or_choice(args.weight_decay)
    else:
        config["batch_size"] = args.batch_size[0]
        config["optim"] = args.optim[0]
        config["learning_rate"] = args.learning_rate[0]
        config["lr_scheduler"] = args.lr_scheduler[0]
        config["LR_gamma"] = args.LR_gamma[0]
        config["weight_decay"] = args.weight_decay[0]
    config["weight_decay_auto"] = args.weight_decay_auto
    config["restart_lr"] = args.restart_lr
    config["min_lr"] = args.min_lr
    if args.segment_center:
        config["segment_center"] = args.segment_center
    if args.sampled_segments:
        # the list flag of train; transfer pins its first value
        config["sampled_segments"] = args.sampled_segments[0]
    config.setdefault("sampled_segments", 10)

    opts = dataclasses.replace(
        opts, model_no=saved.get("model_no", 0),
        model_path=_abspath(args.model_path), train_all=args.train_all,
        init_fc_with_pretrained=args.init_fc_with_pretrained,
        n_class=saved.get("n_class", args.n_class))
    check_ported(opts, model_type)
    run_experiment(config, opts, model_type, _experiment(args))
    return 0


def cmd_convert(args, model_type: str) -> int:
    """Write a reference or mural_tpu checkpoint directory as this
    package's triple (``mural_tpu/cli/main.py:394-402``)."""
    from mural_tpu_torch.device import resolve_device
    from mural_tpu_torch.utils.zoo import convert_checkpoint
    device = resolve_device(args.cpu_only, args.cuda_id)
    convert_checkpoint(_abspath(args.checkpoint_dir),
                       _abspath(args.out_dir), model_type=model_type,
                       device=device)
    return 0


def cmd_get_best_model(args, model_type: str) -> int:
    """One tab-separated line per trial, ``<checkpoint_dir>\t<loss:.6f>``,
    sorted by loss (``mural_tpu/cli/main.py:405-424``)."""
    from mural_tpu_torch.utils.trials import scan_experiment_best
    best = scan_experiment_best(args.trial_path)
    if not best:
        print("No finished trials found under", args.trial_path)
        return 1
    for path, loss in best:
        print(f"{os.path.dirname(path)}\t{loss:.6f}")
    return 0


def cmd_predict(args, model_type: str) -> int:
    from mural_tpu_torch.device import resolve_device
    from mural_tpu_torch.predict import PredictOptions, run_predict
    opts = PredictOptions(
        test_data=_abspath(args.test_data),
        ref_genome=_abspath(args.ref_genome),
        model_path=_abspath(args.model_path),
        model_config_path=_abspath(args.model_config_path),
        calibrator_path=_abspath(args.calibrator_path),
        pred_file=args.pred_file,
        poisson_calib=args.poisson_calib,
        pred_batch_size=args.pred_batch_size,
        segment_center=args.segment_center,
        bw_paths=_abspath(args.bw_paths),
        kmer_corr=args.kmer_corr,
        region_corr=args.region_corr,
        pred_time_view=args.pred_time_view,
        n_devices=args.n_devices,
        fused_inference=args.fused_inference,
        device=resolve_device(args.cpu_only, args.cuda_id),
        with_h5=args.with_h5,
        h5f_path=_abspath(args.h5f_path),
        n_h5_files=args.n_h5_files,
    )
    run_predict(opts, model_type)
    return 0


def cmd_predict_genome(args, model_type: str) -> int:
    """``mural_tpu/cli/main.py:317-336``."""
    from mural_tpu_torch.device import resolve_device
    from mural_tpu_torch.predict.genome_wide import (GenomePredictOptions,
                                                     run_genome_predict)
    opts = GenomePredictOptions(
        ref_genome=_abspath(args.ref_genome),
        model_path=_abspath(args.model_path),
        model_config_path=_abspath(args.model_config_path),
        pred_file=args.pred_file,
        calibrator_path=_abspath(args.calibrator_path),
        poisson_calib=args.poisson_calib,
        focal_base=args.focal_base,
        chroms=args.chroms,
        batch_size=args.pred_batch_size,
        n_devices=args.n_devices,
        n_workers=args.n_workers,
        fused_inference=args.fused_inference,
        time_view=args.pred_time_view,
        device=resolve_device(args.cpu_only, args.cuda_id),
    )
    run_genome_predict(opts, model_type)
    return 0


def cmd_evaluate(args, model_type: str) -> int:
    """k-mer and regional correlation files of a prediction TSV
    (``mural_tpu/cli/main.py:339-373``)."""
    from mural_tpu_torch.evaluation.corr_files import (run_kmer_corr,
                                                       run_motif_corr,
                                                       run_regional_corr)
    assert not (args.kmer_only and args.regional_only), \
        "Please set one of --kmer_only or --regional_only to True."
    strand = None
    if model_type == "indel":
        strand = {"pos": "+", "neg": "-", "both": "both"}[args.strand]

    def kmer():
        assert args.ref_genome, ("--ref_genome is required for k-mer "
                                 "correlation calculation")
        run_kmer_corr(args.pred_file, args.ref_genome, args.out_prefix,
                      args.kmer_length, args.n_class, model_type,
                      strand_override=strand)

    def regional():
        run_regional_corr(args.pred_file, args.out_prefix,
                          args.window_size, args.ratio_cutoff,
                          args.n_class)

    if args.kmer_only:
        kmer()
        return 0
    if args.regional_only:
        regional()
        return 0
    if model_type == "indel" and args.motif_only:
        run_motif_corr(args.pred_file, args.ref_genome, args.out_prefix,
                       args.motif_length, args.n_class, model_type)
        return 0
    kmer()
    regional()
    return 0


def cmd_scale(args, model_type: str) -> int:
    from mural_tpu_torch.predict.scaling import scaling_files
    scaling_files(args.pred_file, args.scale_factor, args.n_class,
                  args.out_file)
    return 0


def cmd_calc_scaling_factor(args, model_type: str) -> int:
    from mural_tpu_torch.predict.scaling import calc_mu_scaling_factor
    calc_mu_scaling_factor(
        args.pred_files, args.genomewide_mu, args.m_proportions,
        args.n_class, model_type,
        g_proportions=getattr(args, "g_proportions", None),
        benchmark_regions=args.benchmark_regions or None,
        do_scaling=args.do_scaling)
    return 0


def main(model_type: str, argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = create_parser(model_type)
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 1
    print(" ".join([f"mural_{model_type}"] + argv))
    return _DISPATCH[args.func](args, model_type)


_DISPATCH = {"train": cmd_train, "transfer": cmd_transfer,
             "predict": cmd_predict,
             "predict_genome": cmd_predict_genome, "evaluate": cmd_evaluate,
             "scale": cmd_scale,
             "calc_scaling_factor": cmd_calc_scaling_factor,
             "get_best_model": cmd_get_best_model, "convert": cmd_convert}

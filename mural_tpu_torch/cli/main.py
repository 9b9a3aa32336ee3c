"""CLI dispatch for mural_snv and mural_indel (counterpart of
``mural_tpu/cli/main.py``).

``train`` (standalone trials, one after another), ``predict``,
``evaluate``, ``scale``, ``calc_scaling_factor`` and ``get_best_model``
are ported; the reference's other sub-commands raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import os
import sys

from mural_tpu_torch.cli import commands as C

_NOT_PORTED = {"transfer": 7, "convert": 7, "predict_genome": 9}


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
    C.add_predict_parser(sub, model_type)
    C.add_evaluate_parser(sub, model_type)
    C.add_scale_parser(sub, model_type)
    C.add_calc_scaling_factor_parser(sub, model_type)
    C.add_get_best_model_parser(sub, model_type)
    return parser


def _abspath(p):
    return os.path.abspath(p) if p else p


def _build_config(args, model_type: str) -> dict:
    """The standalone trial config: the first value of each list flag
    (``mural_tpu/cli/main.py:45-92``)."""
    config = {
        "segment_center": args.segment_center,
        "distal_radius": args.distal_radius[0],
        "CNN_kernel_size": args.CNN_kernel_size[0],
        "CNN_out_channels": args.CNN_out_channels[0],
        "batch_size": args.batch_size[0],
        "sampled_segments": args.sampled_segments[0],
        "learning_rate": args.learning_rate[0],
        "optim": args.optim[0],
        "lr_scheduler": args.lr_scheduler[0],
        "LR_gamma": args.LR_gamma[0],
        "weight_decay": args.weight_decay[0],
        "weight_decay_auto": args.weight_decay_auto,
        "restart_lr": args.restart_lr,
        "min_lr": args.min_lr,
        "transfer_learning": False,
    }
    if model_type == "snv":
        h2 = args.local_hidden2_size[0]
        config.update({
            "local_radius": args.local_radius[0],
            "local_order": args.local_order[0],
            "local_hidden1_size": args.local_hidden1_size[0],
            "local_hidden2_size": (h2 if h2 > 0
                                   else args.local_hidden1_size[0] // 2),
            "emb_dropout": args.emb_dropout[0],
            "distal_fc_dropout": args.distal_fc_dropout[0],
            "local_dropout": args.local_dropout[0],
        })
    else:
        # the U-Net reads only the distal window; the local columns feed
        # the k-mer evaluation
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


def cmd_train(args, model_type: str) -> int:
    from mural_tpu_torch.device import resolve_device
    from mural_tpu_torch.train.loop import TrainOptions, check_ported
    from mural_tpu_torch.tune.runner import ExperimentOptions, run_experiment
    for value, flag in ((args.use_ray, "--use_ray"),
                        (args.n_parallel > 1, "--n_parallel > 1"),
                        (args.trial_ensemble == "auto",
                         "--trial_ensemble auto"),
                        (args.trial_executor == "process",
                         "--trial_executor process"),
                        (args.rerun_failed, "--rerun_failed")):
        if value:
            raise NotImplementedError(
                f"train {flag} is not ported yet (ROADMAP.md item 8)")
    if args.sample_weights:
        print("Warning: sample_weights be dropped, the program will "
              "run with sample_weights=None!")
    opts = TrainOptions(
        train_data=_abspath(args.train_data),
        ref_genome=_abspath(args.ref_genome),
        validation_data=_abspath(args.validation_data),
        bw_paths=_abspath(args.bw_paths),
        distal_order=args.distal_order,
        seq_only=args.seq_only,
        without_bw_distal=args.without_bw_distal,
        n_class=args.n_class,
        model_no=args.model_no,
        epochs=args.epochs,
        valid_ratio=args.valid_ratio,
        split_seed=(args.split_seed if args.split_seed >= 0 else None),
        save_valid_preds=args.save_valid_preds,
        poisson_calib=args.poisson_calib,
        with_h5=args.with_h5,
        grace_period=args.grace_period,
        dp_devices=args.dp_devices,
        profile_dir=args.profile_dir,
        bf16=args.bf16,
        steps_per_dispatch=args.steps_per_dispatch,
        resident=args.resident_data,
        fused_stem=args.fused_stem,
    )
    # fail before any trial starts: a trial's own error goes to its
    # error.txt and the run carries on
    check_ported(opts, model_type)
    opts.device = resolve_device(args.cpu_only, args.cuda_id)
    exp = ExperimentOptions(experiment_name=args.experiment_name,
                            n_trials=args.n_trials, epochs=args.epochs,
                            grace_period=args.grace_period)
    run_experiment(_build_config(args, model_type), opts, model_type, exp)
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
    )
    run_predict(opts, model_type)
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
    if argv and argv[0] in _NOT_PORTED:
        raise NotImplementedError(
            f"mural_{model_type} {argv[0]} is not ported yet "
            f"(ROADMAP.md item {_NOT_PORTED[argv[0]]})")
    parser = create_parser(model_type)
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 1
    print(" ".join([f"mural_{model_type}"] + argv))
    return _DISPATCH[args.func](args, model_type)


_DISPATCH = {"train": cmd_train, "predict": cmd_predict,
             "evaluate": cmd_evaluate, "scale": cmd_scale,
             "calc_scaling_factor": cmd_calc_scaling_factor,
             "get_best_model": cmd_get_best_model}

"""argparse builders of the ported sub-commands (counterpart of
``mural_tpu/cli/commands.py``): ``train``, ``transfer``, ``predict``,
``get_best_model``, ``evaluate``, ``scale``, ``calc_scaling_factor`` and
``convert``, with the JAX package's flags and defaults.
``--cpu_only`` and ``--cuda_id`` have their reference meaning: the run
goes to CUDA device ``--cuda_id`` (default the current one) unless
``--cpu_only`` is given.
"""

from __future__ import annotations

import argparse


def _device_args(g):
    g.add_argument("--cpu_only", default=False, action="store_true",
                   help="Run on the CPU instead of the CUDA device.")
    g.add_argument("--cuda_id", type=str, metavar="STR", default=None,
                   help="CUDA device index. Default: the current device.")


def _learning_args(p, lr_default):
    g = p.add_argument_group("Learning-related arguments")
    g.add_argument("--segment_center", type=int, metavar="INT",
                   default=300000,
                   help="The maximum encoding unit (segment) length of "
                        "the genome. Default: 300000.")
    g.add_argument("--sampled_segments", type=int, metavar="INT",
                   default=[10], nargs="+",
                   help="Number of segments chosen for generating "
                        "batches. Default: 10.")
    g.add_argument("--batch_size", type=int, metavar="INT", default=[128],
                   nargs="+", help="Size of mini batches. Default: 128.")
    g.add_argument("--custom_dataloader", default=False,
                   action="store_true", help=argparse.SUPPRESS)
    g.add_argument("--optim", type=str, metavar="STR", default=["Adam"],
                   nargs="+",
                   help="Optimization method: 'Adam', 'AdamW', 'AdamW2' "
                        "or 'SGD'. Default: 'Adam'.")
    g.add_argument("--learning_rate", type=float, metavar="FLOAT",
                   default=lr_default, nargs="+",
                   help="Learning rate. Default: %(default)s.")
    g.add_argument("--lr_scheduler", type=str, metavar="STR",
                   default=["StepLR"], nargs="+",
                   help="Learning rate scheduler: 'StepLR', 'StepLR2' or "
                        "'ROP'. Default: 'StepLR'.")
    g.add_argument("--weight_decay_auto", type=float, metavar="FLOAT",
                   default=0.1,
                   help="Calculate weight_decay automatically: "
                        "1 - x**(batch_size/(epochs*train_size)). "
                        "Set <=0 to disable. Default: 0.1.")
    g.add_argument("--weight_decay", type=float, metavar="FLOAT",
                   default=[1e-5], nargs="+",
                   help="L2 regularization (used when weight_decay_auto "
                        "is off). Default: 1e-5.")
    g.add_argument("--restart_lr", type=float, metavar="FLOAT",
                   default=1e-4,
                   help="LR after a scheduler restart. Default: 1e-4.")
    g.add_argument("--min_lr", type=float, metavar="FLOAT", default=1e-6,
                   help="Minimum learning rate. Default: 1e-6.")
    g.add_argument("--LR_gamma", type=float, metavar="FLOAT",
                   default=[0.9], nargs="+",
                   help="Gamma of the LR scheduler. Default: 0.9.")
    g.add_argument("--cudnn_benchmark_false", default=False,
                   action="store_true", help=argparse.SUPPRESS)
    g.add_argument("--bf16", default=False, action="store_true",
                   help="bfloat16 activations/compute in the train step "
                        "(float32 parameters, optimizer, BatchNorm "
                        "statistics and loss reduction; the fused stem in "
                        "its single-pass bf16 mode). Loss trajectory "
                        "within tolerance of float32.")
    g.add_argument("--steps_per_dispatch", type=int, metavar="INT",
                   default=None,
                   help="Train steps per replay of one captured CUDA "
                        "graph (eager steps on the CPU); amortises the "
                        "host's per-step launch cost. 1 runs one eager "
                        "step per batch. Default: 8 (SNV), 1 (INDEL).")
    g.add_argument("--resident_data", type=str, metavar="MODE",
                   default="auto", choices=["auto", "on", "off"],
                   help="Keep training data device-resident (the window "
                        "arena uploaded once per trial; windows gathered "
                        "and encoded on the device) instead of building "
                        "batches on a host prefetch thread. 'auto' "
                        "enables it when the data fit the device budget "
                        "and no per-base track channels are used. "
                        "Default: auto.")
    g.add_argument("--fused_stem", type=str, metavar="MODE",
                   default="auto", choices=["auto", "on", "off"],
                   help="Run each distal tower's one-hot+BN+conv+maxpool "
                        "stem as the fused CUDA kernels K2 (forward) and "
                        "K3 (backward) during training (histogram-exact "
                        "BatchNorm statistics, identical parameter "
                        "gradients). 'auto' resolves to off, as in the "
                        "JAX package; 'on' opts in. Default: auto.")
    return g


def _scheduler_args(p, default_experiment):
    g = p.add_argument_group("Trial-scheduler arguments")
    g.add_argument("--use_ray", default=False, action="store_true",
                   help="Use the ASHA trial scheduler with hyperparameter "
                        "search over the provided value lists.")
    g.add_argument("--experiment_name", type=str, metavar="STR",
                   default=default_experiment,
                   help="Experiment name. Default: %(default)s.")
    g.add_argument("--n_trials", type=int, metavar="INT", default=2,
                   help="Number of trials. Default: 2.")
    g.add_argument("--epochs", type=int, metavar="INT", default=10,
                   help="Max training epochs per trial. Default: 10.")
    g.add_argument("--grace_period", type=int, metavar="INT", default=5,
                   help="Min epochs before early stopping. Default: 5.")
    g.add_argument("--ASHA_metric", type=str, metavar="STR",
                   default="loss",
                   help="Metric for ASHA ('loss' or 'fdiri_loss'). "
                        "Default: loss.")
    for flag, kind, default in (("--ray_ncpus", int, 2),
                                ("--ray_ngpus", int, 1),
                                ("--cpu_per_trial", int, 2),
                                ("--gpu_per_trial", float, 0.15)):
        g.add_argument(flag, type=kind, default=default,
                       help=argparse.SUPPRESS)
    _device_args(g)
    g.add_argument("--n_parallel", type=int, metavar="INT", default=1,
                   help="Trials run concurrently, one per CUDA device. "
                        "Default: 1.")
    g.add_argument("--trial_executor", type=str, metavar="MODE",
                   default="thread", choices=["thread", "process"],
                   help="Trial executor: 'thread' (one process) or "
                        "'process' (a spawned process per trial). "
                        "Default: thread.")
    g.add_argument("--trial_ensemble", type=str, metavar="MODE",
                   default="off", choices=["off", "auto"],
                   help="'auto' trains same-architecture trials as ONE "
                        "vmapped group (torch.func) sharing one dataset "
                        "encode and one device arena, with each trial's "
                        "learning rate, weight decay and seed its own; "
                        "trials needing different programs run "
                        "normally. Default: off.")
    g.add_argument("--dp_devices", type=int, metavar="INT", default=1,
                   help="Data-parallel training over this many CUDA "
                        "devices (batch sharded, grads all-reduced). "
                        "Default: 1.")
    g.add_argument("--profile_dir", type=str, metavar="DIR", default=None,
                   help="Write a torch.profiler trace of the first "
                        "epoch's train steps into this directory (one "
                        "step per call while profiling).")
    g.add_argument("--rerun_failed", default=False, action="store_true",
                   help="Re-run errored trials of a previous experiment.")
    return g


def _data_args(p):
    g = p.add_argument_group("Data-related arguments")
    g.add_argument("--validation_data", type=str, metavar="FILE",
                   default=None,
                   help="Validation BED file; without it, "
                        "--valid_ratio of training data is used.")
    g.add_argument("--sample_weights", type=str, metavar="FILE",
                   default=None, help=argparse.SUPPRESS)
    g.add_argument("--valid_ratio", type=float, metavar="FLOAT",
                   default=0.1,
                   help="Fraction of segments used for validation. "
                        "Default: 0.1.")
    g.add_argument("--split_seed", type=int, metavar="INT", default=-1,
                   help="Seed for the train/validation split; -1 draws "
                        "a random seed. Default: -1.")
    g.add_argument("--bw_paths", type=str, metavar="FILE", default=None,
                   help="List file of coverage tracks "
                        "(path name [radius] rows).")
    g.add_argument("--without_bw_distal", default=False,
                   action="store_true",
                   help="Do not use track data for distal regions.")
    g.add_argument("--seq_only", default=False, action="store_true",
                   help="Use only genomic sequence, ignore tracks.")
    g.add_argument("--with_h5", default=False, action="store_true",
                   help="Use the on-disk site-table cache (the "
                        "reference's H5 pre-encoding analogue; windows "
                        "are still encoded on the fly from uint8 codes).")
    g.add_argument("--h5f_path", type=str, metavar="FILE", default=None,
                   help="Site-table cache path. Default: derived from "
                        "the training data path.")
    g.add_argument("--n_h5_files", type=int, metavar="INT", default=1,
                   help=argparse.SUPPRESS)
    g.add_argument("--save_valid_preds", default=False,
                   action="store_true",
                   help="Save validation predictions per checkpoint.")
    return g


def add_train_parser(subparsers, model_type: str):
    p = subparsers.add_parser(
        "train", help="Train models with the provided data",
        formatter_class=argparse.RawTextHelpFormatter)
    req = p.add_argument_group("Required arguments")
    req.add_argument("--ref_genome", type=str, metavar="FILE", default="",
                     required=True, help="Reference genome FASTA.")
    req.add_argument("--train_data", type=str, metavar="FILE", default="",
                     required=True, help="Sorted training BED file.")
    _data_args(p)
    m = p.add_argument_group("Model-related arguments")
    m.add_argument("--distal_order", type=int, metavar="INT", default=1,
                   help="Order of distal sequence encoding. Default: 1.")
    m.add_argument("--CNN_kernel_size", type=int, metavar="INT",
                   default=[3] if model_type == "snv" else [7], nargs="+",
                   help="Kernel size of the first convolution.")
    m.add_argument("--CNN_out_channels", type=int, metavar="INT",
                   default=[32] if model_type == "snv" else [8], nargs="+",
                   help="Output channels of the first convolution.")
    if model_type == "snv":
        m.add_argument("--model_no", type=int, metavar="INT", default=2,
                       help="Model architecture: 0 local-only, 1 "
                            "expanded-only, 2 combined. Default: 2.")
        m.add_argument("--n_class", type=int, metavar="INT", default=4,
                       help="Number of mutation classes. Default: 4.")
        for flag, kind, default, text in (
                ("--distal_radius", int, 200,
                 "Radius of the expanded (distal) region."),
                ("--local_radius", int, 7, "Radius of the local region."),
                ("--local_order", int, 3,
                 "K-mer order for local sequences."),
                ("--local_hidden1_size", int, 150,
                 "First FC layer size of the local branch."),
                ("--local_hidden2_size", int, 0,
                 "Second FC layer size (0 -> hidden1 // 2)."),
                ("--emb_dropout", float, 0.1,
                 "Dropout of the embedding layer."),
                ("--local_dropout", float, 0.1,
                 "Dropout of local FC layers."),
                ("--distal_fc_dropout", float, 0.25,
                 "Dropout of the distal FC layer.")):
            m.add_argument(flag, type=kind,
                           metavar="INT" if kind is int else "FLOAT",
                           default=[default], nargs="+", help=text)
    else:
        m.add_argument("--model_no", type=int, metavar="INT", default=0,
                       help="INDEL model architecture (0: U-Net).")
        m.add_argument("--distal_radius", type=int, metavar="INT",
                       default=[4000], nargs="+",
                       help="Radius of the expanded region.")
        m.add_argument("--n_class", type=int, metavar="INT", default=8,
                       help="Number of INDEL classes. Default: 8.")
        m.add_argument("--down_list", type=int, metavar="INT",
                       default=[1, 4, 5, 5, 5, 2], nargs="+",
                       help="Per-level downsampling strides of the "
                            "U-Net encoder.")
        m.add_argument("--use_reverse", default=False,
                       action="store_true",
                       help="Strand-symmetrised stem (insertion models).")
    c = p.add_argument_group("Calibration-related arguments")
    c.add_argument("--poisson_calib", default=False, action="store_true",
                   help="Poisson-based probability calibration of the "
                        "validation evaluation.")
    _learning_args(p, [0.001])
    _scheduler_args(p, f"{model_type}_experiment")
    p.set_defaults(func="train")
    return p


def add_transfer_parser(subparsers, model_type: str):
    p = subparsers.add_parser(
        "transfer", help="Transfer learning from a trained model",
        formatter_class=argparse.RawTextHelpFormatter)
    req = p.add_argument_group("Required arguments")
    req.add_argument("--ref_genome", type=str, metavar="FILE", default="",
                     required=True, help="Reference genome FASTA.")
    req.add_argument("--train_data", type=str, metavar="FILE", default="",
                     required=True, help="Sorted training BED file.")
    req.add_argument("--model_path", type=str, metavar="FILE",
                     required=True, help="Pre-trained checkpoint "
                     "('model' file: a torch state_dict or a mural_tpu "
                     "msgpack file).")
    req.add_argument("--model_config_path", type=str, metavar="FILE",
                     required=True, help="Pickled config of the "
                     "pre-trained model.")
    m = p.add_argument_group("Model-related arguments")
    m.add_argument("--train_all", default=False, action="store_true",
                   help="Fine-tune all parameters (else only final FCs).")
    m.add_argument("--init_fc_with_pretrained", default=False,
                   action="store_true",
                   help="Keep pre-trained final FC weights instead of "
                        "re-initialising them.")
    m.add_argument("--n_class", type=int, metavar="INT",
                   default=4 if model_type == "snv" else 8,
                   help="Number of mutation classes.")
    _data_args(p)
    _learning_args(p, [0.0001])
    c = p.add_argument_group("Calibration-related arguments")
    c.add_argument("--poisson_calib", default=False, action="store_true",
                   help="Poisson-based probability calibration.")
    _scheduler_args(p, "my_experiment")
    # segment_center and sampled_segments come from the checkpoint config
    # unless given (ref commands/transfer.py:98-109)
    p.set_defaults(func="transfer", segment_center=None,
                   sampled_segments=None)
    return p


def add_convert_parser(subparsers, model_type: str):
    """``convert``: write a reference torch checkpoint directory or a
    mural_tpu one (state_dict or msgpack, config and calibrator pickles)
    as this package's triple."""
    p = subparsers.add_parser(
        "convert", help="Convert a reference or mural_tpu checkpoint "
        "directory to this package's checkpoint triple",
        formatter_class=argparse.RawTextHelpFormatter)
    req = p.add_argument_group("Required arguments")
    req.add_argument("--checkpoint_dir", required=True, type=str,
                     metavar="DIR",
                     help="Checkpoint directory holding 'model' (torch "
                          "state_dict or mural_tpu msgpack), "
                          "'model.config.pkl' and optionally "
                          "'model.fdiri_cal.pkl'.")
    req.add_argument("--out_dir", required=True, type=str, metavar="DIR",
                     help="Output directory for the triple (created if "
                          "missing).")
    _device_args(p.add_argument_group("Device arguments"))
    p.set_defaults(func="convert")
    return p


def add_get_best_model_parser(subparsers, model_type: str):
    p = subparsers.add_parser(
        "get_best_model", help="Pick the best checkpoints of an "
        "experiment", formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--trial_path", required=True, type=str,
                   metavar="FILE", help="Experiment directory containing "
                   "Train_* trial folders.")
    p.set_defaults(func="get_best_model")
    return p


def add_predict_parser(subparsers, model_type: str):
    p = subparsers.add_parser(
        "predict", help="Predict mutation rates with a trained model",
        formatter_class=argparse.RawTextHelpFormatter)
    req = p.add_argument_group("Required arguments")
    req.add_argument("--ref_genome", type=str, metavar="FILE", default="",
                     required=True, help="Reference genome FASTA.")
    req.add_argument("--test_data", type=str, metavar="FILE",
                     required=True, help="Sorted BED of sites to predict.")
    req.add_argument("--model_path", type=str, metavar="FILE",
                     required=True, help="Trained checkpoint file.")
    req.add_argument("--model_config_path", type=str, metavar="FILE",
                     required=True, help="Pickled model config.")
    opt = p.add_argument_group("Optional arguments")
    opt.add_argument("--pred_file", type=str, metavar="FILE",
                     default="pred.tsv.gz",
                     help="Output TSV. Default: pred.tsv.gz.")
    opt.add_argument("--calibrator_path", type=str, metavar="FILE",
                     default="", help="Pickled calibrator "
                     "(model.fdiri_cal.pkl).")
    opt.add_argument("--poisson_calib", default=False,
                     action="store_true",
                     help="Poisson-based probability calibration.")
    opt.add_argument("--bw_paths", type=str, metavar="FILE", default=None,
                     help="List file of coverage tracks.")
    opt.add_argument("--n_h5_files", type=int, metavar="INT", default=1,
                     help=argparse.SUPPRESS)
    opt.add_argument("--pred_time_view", default=False,
                     action="store_true",
                     help="Log fetch/predict timing every 500 batches.")
    opt.add_argument("--with_h5", default=False, action="store_true",
                     help="Use the on-disk site-table cache (see "
                          "train --with_h5).")
    opt.add_argument("--h5f_path", type=str, metavar="FILE",
                     default=None,
                     help="Site-table cache path. Default: derived "
                          "from the test data path.")
    _device_args(opt)
    opt.add_argument("--segment_center", type=int, metavar="INT",
                     default=None,
                     help="Override the segment length of the checkpoint "
                          "config.")
    opt.add_argument("--pred_batch_size", type=int, metavar="INT",
                     default=16, help="Batch size. Default: 16.")
    opt.add_argument("--n_devices", type=int, metavar="INT", default=1,
                     help="Shard inference over this many CUDA "
                          "devices.")
    opt.add_argument("--fused_inference", default=False,
                     action="store_true",
                     help="BN-folded fused forward with the CUDA stem "
                          "kernel (SNV model_no 2 only).")
    opt.add_argument("--kmer_corr", type=int, metavar="INT", default=[],
                     nargs="+", help="Inline k-mer correlations for "
                     "these odd k values.")
    opt.add_argument("--region_corr", type=int, metavar="INT", default=[],
                     nargs="+", help="Inline regional correlations for "
                     "these window sizes.")
    p.set_defaults(func="predict")
    return p


def add_predict_genome_parser(subparsers, model_type: str):
    p = subparsers.add_parser(
        "predict_genome",
        help="Genome-wide rate map without a BED: predicts every "
             "focal-base position, streaming output",
        formatter_class=argparse.RawTextHelpFormatter)
    req = p.add_argument_group("Required arguments")
    req.add_argument("--ref_genome", type=str, metavar="FILE",
                     required=True, help="Reference genome FASTA.")
    req.add_argument("--model_path", type=str, metavar="FILE",
                     required=True, help="Trained checkpoint file.")
    req.add_argument("--model_config_path", type=str, metavar="FILE",
                     required=True, help="Pickled model config.")
    opt = p.add_argument_group("Optional arguments")
    opt.add_argument("--pred_file", type=str, metavar="FILE",
                     default="genome_pred.tsv.gz",
                     help="Output TSV. Default: genome_pred.tsv.gz.")
    opt.add_argument("--calibrator_path", type=str, metavar="FILE",
                     default="", help="Pickled calibrator.")
    opt.add_argument("--poisson_calib", default=False,
                     action="store_true",
                     help="Poisson-based probability calibration.")
    opt.add_argument("--focal_base", type=str,
                     default="A" if model_type == "snv" else "all",
                     choices=["A", "C", "G", "T", "all"],
                     help="The model's focal base; '+' sites carry it, "
                          "'-' sites its complement. 'all' predicts "
                          "every position on '+' (INDEL mode). "
                          "Default: %(default)s.")
    opt.add_argument("--chroms", type=str, nargs="+", default=None,
                     help="Restrict to these chromosomes.")
    opt.add_argument("--pred_batch_size", type=int, metavar="INT",
                     default=4096 if model_type == "snv" else 1024,
                     help="Batch size (INDEL windows are 20-40x wider "
                          "than SNV ones, so its default is smaller). "
                          "Default: %(default)s.")
    opt.add_argument("--n_devices", type=int, metavar="INT", default=1,
                     help="Shard over this many CUDA devices.")
    opt.add_argument("--n_workers", type=int, metavar="INT", default=None,
                     help="Postprocess worker processes (calibration + "
                          "formatting + gzip). 0 = inline. Default: "
                          "auto-size from the host core count -- inline "
                          "on <=2 cores, else cores-2 capped at 6.")
    opt.add_argument("--fused_inference", default=False,
                     action="store_true",
                     help="BN-folded fused forward with the CUDA stem "
                          "kernel (SNV model_no 2 only).")
    opt.add_argument("--pred_time_view", default=False,
                     action="store_true",
                     help="Print a phase-timing table.")
    _device_args(opt)
    p.set_defaults(func="predict_genome")
    return p


def add_evaluate_parser(subparsers, model_type: str):
    p = subparsers.add_parser(
        "evaluate", help="Evaluate obs/pred correlations of predictions",
        formatter_class=argparse.RawTextHelpFormatter)
    req = p.add_argument_group("Required arguments")
    req.add_argument("--pred_file", required=True, type=str,
                     help="Predicted file")
    req.add_argument("--out_prefix", default="result", type=str,
                     help="Output filename prefix")
    req.add_argument("--kmer_only", default=False, action="store_true",
                     help="Only run the k-mer correlation.")
    req.add_argument("--regional_only", default=False,
                     action="store_true",
                     help="Only run the regional correlation.")
    req.add_argument("--motif_only", default=False, action="store_true",
                     help="Only run the motif correlation (INDEL).")
    req.add_argument("--n_class", type=int,
                     default=4 if model_type == "snv" else 8,
                     help="Number of classes.")
    k = p.add_argument_group("k-mer arguments")
    k.add_argument("--ref_genome", required=False, default=None, type=str,
                   help="Reference genome FASTA (k-mer/motif mode).")
    k.add_argument("--kmer_length", type=int,
                   default=3 if model_type == "snv" else 2,
                   help="k-mer length (odd for SNV, even for INDEL "
                        "whose windows span the gap).")
    k.add_argument("--motif_length", type=int,
                   default=3 if model_type == "snv" else 6,
                   help=argparse.SUPPRESS)
    if model_type == "indel":
        k.add_argument("--strand", type=str, default="pos",
                       choices=["pos", "neg", "both"],
                       help="Read k-mers from which strand.")
    r = p.add_argument_group("Regional arguments")
    r.add_argument("--window_size", type=int, default=100000,
                   help="Window size for regional correlation.")
    r.add_argument("--ratio_cutoff", type=float, default=0.2,
                   help="Cutoff (x median sites) to drop sparse windows.")
    p.set_defaults(func="evaluate")
    return p


def add_scale_parser(subparsers, model_type: str):
    p = subparsers.add_parser(
        "scale", help="Apply scaling factors to predictions",
        formatter_class=argparse.RawTextHelpFormatter)
    g = p.add_argument_group("Required arguments")
    g.add_argument("--pred_file", required=True, type=str, metavar="FILE",
                   nargs="+", help="Prediction file(s).")
    g.add_argument("--scale_factor", required=True, type=float,
                   metavar="FLOAT", nargs="+", help="Scaling factor(s).")
    g.add_argument("--out_file", type=str, metavar="FILE", nargs="+",
                   help="Output file(s).")
    g.add_argument("--benchmark_regions", type=str, metavar="FILE",
                   default="", help=argparse.SUPPRESS)
    g.add_argument("--genomewide_mu", type=float, metavar="FLOAT",
                   default=None, help=argparse.SUPPRESS)
    g.add_argument("--n_class", type=int,
                   default=4 if model_type == "snv" else 8,
                   help="Number of classes.")
    p.set_defaults(func="scale")
    return p


def add_calc_scaling_factor_parser(subparsers, model_type: str):
    p = subparsers.add_parser(
        "calc_scaling_factor",
        help="Calculate per-class rate scaling factors",
        formatter_class=argparse.RawTextHelpFormatter)
    g = p.add_argument_group("Required arguments")
    g.add_argument("--pred_files", required=True, type=str,
                   metavar="FILE", nargs="+", help="Prediction file(s), "
                   "one per mutation type.")
    g.add_argument("--out_file", type=str, metavar="FILE", nargs="+",
                   help="Output file(s).")
    g.add_argument("--benchmark_regions", type=str, metavar="FILE",
                   default="", help="BED of benchmark regions to "
                   "restrict the calculation.")
    g.add_argument("--genomewide_mu", type=float, metavar="FLOAT",
                   default=None, help="Genome-wide per-generation "
                   "mutation rate.")
    g.add_argument("--m_proportions", type=float, metavar="float",
                   nargs="+", help="Proportion of each mutation type.")
    g.add_argument("--do_scaling", default=False, action="store_true",
                   help="Also write scaled prediction files.")
    if model_type == "snv":
        g.add_argument("--g_proportions", type=float, metavar="FLOAT",
                       nargs="+", help="Genome proportion of each "
                       "focal-base group.")
    g.add_argument("--n_class", type=int,
                   default=4 if model_type == "snv" else 8,
                   help="Number of classes.")
    p.set_defaults(func="calc_scaling_factor")
    return p

"""argparse builder of the ported sub-command (counterpart of
``mural_tpu/cli/commands.py:306-366``): ``predict``, with the reference's
flags and defaults.  ``--cpu_only`` and ``--cuda_id`` have their
reference meaning: the run goes to CUDA device ``--cuda_id`` (default
the current one) unless ``--cpu_only`` is given.
"""

from __future__ import annotations

import argparse


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
                     help="List file of coverage tracks (not ported yet).")
    opt.add_argument("--n_h5_files", type=int, metavar="INT", default=1,
                     help=argparse.SUPPRESS)
    opt.add_argument("--pred_time_view", default=False,
                     action="store_true",
                     help="Log fetch/predict timing every 500 batches.")
    opt.add_argument("--with_h5", default=False, action="store_true",
                     help="Use the on-disk site-table cache (not ported "
                          "yet).")
    opt.add_argument("--h5f_path", type=str, metavar="FILE",
                     default=None, help=argparse.SUPPRESS)
    opt.add_argument("--cpu_only", default=False, action="store_true",
                     help="Run on the CPU instead of the CUDA device.")
    opt.add_argument("--cuda_id", type=str, metavar="STR", default=None,
                     help="CUDA device index. Default: the current "
                          "device.")
    opt.add_argument("--segment_center", type=int, metavar="INT",
                     default=None,
                     help="Override the segment length of the checkpoint "
                          "config.")
    opt.add_argument("--pred_batch_size", type=int, metavar="INT",
                     default=16, help="Batch size. Default: 16.")
    opt.add_argument("--n_devices", type=int, metavar="INT", default=1,
                     help="Shard inference over this many devices (not "
                          "ported yet).")
    opt.add_argument("--fused_inference", default=False,
                     action="store_true",
                     help="BN-folded fused forward with the CUDA stem "
                          "kernel (SNV model_no 2 only).")
    opt.add_argument("--kmer_corr", type=int, metavar="INT", default=[],
                     nargs="+", help="Inline k-mer correlations for "
                     "these odd k values (not ported yet).")
    opt.add_argument("--region_corr", type=int, metavar="INT", default=[],
                     nargs="+", help="Inline regional correlations for "
                     "these window sizes (not ported yet).")
    p.set_defaults(func="predict")
    return p

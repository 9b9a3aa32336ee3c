"""CLI dispatch for mural_snv (counterpart of ``mural_tpu/cli/main.py``).

Only ``predict`` is ported; the reference's other sub-commands raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import os
import sys

from mural_tpu_torch.cli import commands as C

_NOT_PORTED = {
    "train": 2, "get_best_model": 2, "evaluate": 3, "scale": 4,
    "calc_scaling_factor": 4, "transfer": 7, "convert": 7,
    "predict_genome": 9,
}


def create_parser(model_type: str) -> argparse.ArgumentParser:
    prog = f"mural_{model_type}"
    parser = argparse.ArgumentParser(
        prog=prog,
        description=f"{prog}: germline "
                    f"{'SNV' if model_type == 'snv' else 'INDEL'} "
                    "mutation rate estimation on PyTorch/CUDA",
        formatter_class=argparse.RawTextHelpFormatter)
    sub = parser.add_subparsers(dest="command")
    C.add_predict_parser(sub, model_type)
    return parser


def _abspath(p):
    return os.path.abspath(p) if p else p


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


def main(model_type: str, argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _NOT_PORTED:
        raise NotImplementedError(
            f"mural_{model_type} {argv[0]} is not ported yet "
            f"(ROADMAP.md item {_NOT_PORTED[argv[0]]})")
    if model_type != "snv":
        raise NotImplementedError(
            "mural_indel is not ported yet (ROADMAP.md item 5)")
    parser = create_parser(model_type)
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 1
    print(" ".join([f"mural_{model_type}"] + argv))
    return cmd_predict(args, model_type)

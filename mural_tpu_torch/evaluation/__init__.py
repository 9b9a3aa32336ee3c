from mural_tpu_torch.calibrate.fit import calibrate_prob
from mural_tpu_torch.evaluation.evaluator import (Evaluator, calc_avg_prob,
                                                  corr_calc_sub,
                                                  freq_kmer_comp_multi)

__all__ = ["Evaluator", "freq_kmer_comp_multi", "corr_calc_sub",
           "calc_avg_prob", "calibrate_prob"]

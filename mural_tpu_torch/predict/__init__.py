from mural_tpu_torch.predict.pipeline import PredictOptions, run_predict

__all__ = ["PredictOptions", "run_predict"]

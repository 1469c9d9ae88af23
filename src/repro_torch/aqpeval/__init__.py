from repro_torch.aqpeval.evaluator import ApproxEvalResult, GuaranteedEvaluator

__all__ = ["ApproxEvalResult", "GuaranteedEvaluator"]

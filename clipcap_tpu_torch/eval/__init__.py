from clipcap_tpu_torch.eval.metrics import evaluate_metrics, evaluate_metrics_from_lists

__all__ = ["evaluate_metrics", "evaluate_metrics_from_lists"]

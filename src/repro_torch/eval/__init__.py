from repro_torch.eval.passk import EvalResult, evaluate_passk, pass_at_k_estimator  # noqa: F401

from repro_torch.rewards.verifier import ArithmeticVerifier, LengthPenaltyWrapper  # noqa: F401

from repro_torch.data.dataset import (  # noqa: F401
    ArithmeticProblem, ArithmeticTask, BOS, EOS, PAD, VOCAB,
    decode_number, encode_number, pad_and_stack)

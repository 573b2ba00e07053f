"""PyTorch/CUDA port of the ROLL Flash reproduction.

A second package beside the JAX package ``repro``, which stays the
reference.  It imports ``torch``, numpy and the standard library, and
nothing of ``repro``.  It serves a dense decoder (Qwen3-4B at full width)
through ``LLMProxy`` and ``PagedDecodeEngine``, in full precision or as
quantized rollouts (int8/fp8 weights quantized at every sync, an int8 KV
pool), with decode attention in a hand-written CUDA kernel for Hopper
(``csrc/``), and trains on the rollouts (``algos``, ``train``: GRPO
losses, fp32-master AdamW, ``HostTrainer``) with the trainer's attention
in hand-written flash forward and backward kernels.  The slot
``DecodeEngine`` serves the dense family from a dense KV cache and the
RWKV-6 family from its recurrent state, with hand-written decode-attention
and WKV-scan kernels, and drives Pass@k evaluation (``eval``).  The
RecurrentGemma hybrid, the MoE family (Qwen3-MoE-235B-A22B, DBRX-132B:
the reference's capacity-factor dispatch, served by both engines, trained
with its router losses) and the asynchronous pipeline (``launch``) run on
the same kernels.
"""

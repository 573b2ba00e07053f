"""The plain reference: Qwen3 in fp32 (TF32 off), the GRPO / decoupled-PPO
loss and AdamW, in plain PyTorch.  It imports nothing of the port."""

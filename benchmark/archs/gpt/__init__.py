"""The port's dense GPT family: RoPE over the whole head, RMSNorm, SwiGLU,
multi-head attention, an untied head (``ray_tpu_torch.models.GPTConfig``
with no experts)."""

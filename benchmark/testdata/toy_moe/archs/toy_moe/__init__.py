"""A test architecture outside the dense family: the port's GPT with
top-k routed experts (``GPTConfig(n_experts=..., expert_top_k=...)``),
its Switch load-balancing loss counted over the whole batch."""

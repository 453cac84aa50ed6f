"""DeepSeek-V3's decoder as Moonlight-16B-A3B has it, on one card of an
expert-parallel deployment: latent attention (MLA), sigmoid-routed
experts of which the card holds its share, shared experts and dense
leading layers (``ray_tpu_torch.models.GPTConfig`` with ``kv_lora_rank``
and ``router="sigmoid"``)."""

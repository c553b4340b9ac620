from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    BF16_ATOL, BF16_ULPS, CUDA_LAUNCHES_PER_CALL, FlashAttentionFn,
    bf16_limit_share, flash_attention, flash_attention_ref, variant,
)

"""Zamba2-1.2B [arXiv:2411.15242; hf Zyphra/Zamba2-1.2B] — Mamba2 backbone
with one SHARED attention(+MLP) block applied periodically.

38L d_model=2048; attention 32H (kv=32, d_head=64) d_ff=8192; ssm_state=64;
vocab 32000.  The shared block fires every 6 layers (6 applications).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, d_inner=4096, ssm_head_dim=64, ssm_chunk=256,
    attn_every=6,
)

REDUCED = dataclasses.replace(
    CONFIG, name="zamba2-reduced",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
    vocab=256, ssm_state=16, d_inner=128, ssm_head_dim=32, ssm_chunk=16,
    attn_every=2, logit_chunk=32,
)

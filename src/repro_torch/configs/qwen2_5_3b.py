"""Qwen2.5-3B [hf Qwen/Qwen2.5-3B] — GQA with QKV bias.

36L d_model=2048 16H (GQA kv=2, d_head=128) d_ff=11008 vocab 151936.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_head=128,
    d_ff=11008, vocab=151936, qkv_bias=True,
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen2.5-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=192,
    vocab=256, logit_chunk=32,
)

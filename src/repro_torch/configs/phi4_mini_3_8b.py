"""Phi-4-mini 3.8B [arXiv:2412.08905; hf microsoft/Phi-4-mini-instruct].

32L d_model=3072 24H (GQA kv=8, d_head=128) d_ff=8192 vocab 200064,
RoPE + SwiGLU + GQA.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=200064,
)

REDUCED = dataclasses.replace(
    CONFIG, name="phi4-mini-reduced",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_head=16, d_ff=256,
    vocab=256, logit_chunk=32,
)

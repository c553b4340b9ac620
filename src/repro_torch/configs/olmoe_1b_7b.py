"""OLMoE-1B-7B [arXiv:2409.02060; hf allenai/OLMoE-1B-7B-0924].

16L d_model=2048 16H (kv=16, MHA) expert d_ff=1024, 64 experts top-8,
vocab 50304.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, d_ff_expert=1024,
)

REDUCED = dataclasses.replace(
    CONFIG, name="olmoe-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=64,
    vocab=256, n_experts=8, top_k=2, d_ff_expert=32, logit_chunk=32,
)

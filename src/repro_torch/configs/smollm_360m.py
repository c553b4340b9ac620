"""SmolLM-360M [hf HuggingFaceTB/SmolLM-360M] — llama-arch small.

32L d_model=960 15H (GQA kv=5, d_head=64) d_ff=2560 vocab 49152.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_head=64,
    d_ff=2560, vocab=49152,
)

REDUCED = dataclasses.replace(
    CONFIG, name="smollm-reduced",
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, d_head=32, d_ff=256,
    vocab=256, logit_chunk=32,
)

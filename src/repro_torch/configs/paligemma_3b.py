"""PaliGemma-3B [arXiv:2407.07726; hf google/paligemma-3b-pt-224].

Gemma-2B text backbone: 18L d_model=2048 8H (MQA kv=1, d_head=256)
d_ff=16384 vocab 257216.  SigLIP vision tower is a STUB — ``input_specs``
provides 256 precomputed patch embeddings per image (224px / 14px patches).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
    d_ff=16384, vocab=257216,
    frontend="patch_embeds", n_prefix=256,
)

REDUCED = dataclasses.replace(
    CONFIG, name="paligemma-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_head=16, d_ff=192,
    vocab=256, n_prefix=8, logit_chunk=32,
)

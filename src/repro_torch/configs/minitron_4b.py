"""Minitron-4B [arXiv:2407.14679; hf nvidia/Minitron-4B-Base] — pruned
Nemotron.  32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab 256000.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=9216, vocab=256000,
)

REDUCED = dataclasses.replace(
    CONFIG, name="minitron-reduced",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_head=16, d_ff=288,
    vocab=256, logit_chunk=32,
)

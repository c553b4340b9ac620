"""MusicGen-large [arXiv:2306.05284; hf facebook/musicgen-large].

Decoder-only over EnCodec tokens: 48L d_model=2048 32H (kv=32, d_head=64)
d_ff=8192 vocab 2048.  The EnCodec frontend is a STUB — ``input_specs``
provides precomputed frame embeddings (sum of codebook embeddings).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=2048,
    frontend="frame_embeds",
)

REDUCED = dataclasses.replace(
    CONFIG, name="musicgen-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
    vocab=128, logit_chunk=32,
)

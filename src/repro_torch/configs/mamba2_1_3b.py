"""Mamba2-1.3B [arXiv:2405.21060; hf state-spaces/mamba2-1.3b] — attention-
free SSD.  48L d_model=2048 d_inner=4096 headdim=64 ssm_state=128
vocab 50280.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab=50280,
    ssm_state=128, d_inner=4096, ssm_head_dim=64, ssm_chunk=256,
)

REDUCED = dataclasses.replace(
    CONFIG, name="mamba2-reduced",
    n_layers=2, d_model=64, d_ff=0, vocab=256,
    ssm_state=16, d_inner=128, ssm_head_dim=32, ssm_chunk=16,
    logit_chunk=32,
)

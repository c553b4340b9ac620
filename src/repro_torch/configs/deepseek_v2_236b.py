"""DeepSeek-V2 236B [arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2].

60L d_model=5120 128H MLA(kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64,
v_head=128), MoE: 2 shared + 160 routed top-6, expert d_ff=1536, first layer
dense (d_ff=12288), vocab 102400.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=12288, vocab=102400,
    n_experts=160, n_shared_experts=2, top_k=6, d_ff_expert=1536,
    first_dense=1,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
)

REDUCED = dataclasses.replace(
    CONFIG, name="deepseek-v2-reduced",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
    vocab=256, n_experts=8, n_shared_experts=1, top_k=2, d_ff_expert=32,
    q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, logit_chunk=32,
)

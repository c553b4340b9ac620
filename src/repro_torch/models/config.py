"""Model / shape configuration of the LM stack (PyTorch port).

The same data as the JAX package's ``models/config.py``: one frozen
``ModelConfig`` per architecture lives in ``repro_torch/configs/<id>.py``
with a ``REDUCED`` miniature for CPU tests.  ``attn_impl`` / ``ssm_impl``
select the model's reference path (``"ref"``, the JAX package's ``"xla"``)
or the hand-written kernel (``"kernel"``, its ``"pallas"``); on CPU tensors
the kernel wrappers run their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

IMPLS = ("ref", "kernel")
_FROM_JAX_IMPL = {"xla": "ref", "pallas": "kernel"}


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense: int = 0     # deepseek: leading layers use a dense MLP
    capacity_factor: float = 1.25
    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    d_inner: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- hybrid (zamba2): shared attention block applied every k layers ---
    attn_every: int = 0
    # --- modality frontends (STUBS: input_specs provides embeddings) ---
    frontend: str = "none"   # none | patch_embeds | frame_embeds
    n_prefix: int = 0        # vlm: image-patch positions at sequence start
    # --- misc ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    remat: bool = True       # training: torch.utils.checkpoint a layer
    scan_layers: bool = True  # JAX-only (lax.scan vs unroll): unused here
    attn_impl: str = "ref"   # ref | kernel (flash_attention CUDA kernel)
    ssm_impl: str = "ref"    # ref | kernel (ssd_scan CUDA kernel)
    logit_chunk: int = 512   # sequence chunk for the cross-entropy loss
    vocab_pad: int = 256
    # --- JAX distribution strategy: carried so configs are the same data;
    # the port runs on one card and reads neither ---
    seq_parallel: str = "off"
    moe_impl: str = "psum"

    @property
    def vocab_padded(self) -> int:
        return _pad_to(self.vocab, self.vocab_pad)

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.d_inner else 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch hold a 524k context (O(1)-ish state)?"""
        return self.family in ("ssm", "hybrid")

    @property
    def n_attn_applications(self) -> int:
        """How many attention KV caches a decode step needs."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.n_layers // self.attn_every
        return self.n_layers

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        n = 2 * self.vocab_padded * d            # embed + unembed
        if self.family in ("ssm", "hybrid"):
            di, st, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            # in_proj (z,x,B,C,dt) + out_proj + conv + A,D + norms
            ssm_block = (d * (2 * di + 2 * st + H) + di * d
                         + self.conv_width * (di + 2 * st) + 2 * H + 2 * d)
            n += L * ssm_block
            if self.family == "hybrid":
                # one shared attention+MLP block (+ per-slot LN)
                n += 4 * d * d + 3 * d * self.d_ff + 2 * d
            return n
        if self.use_mla:
            attn = (d * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = d * (self.n_heads * self.d_head) * 2 \
                + d * (self.n_kv_heads * self.d_head) * 2
        n += L * (attn + 2 * d)
        n_moe = L - self.first_dense if self.n_experts else 0
        n_dense = L - n_moe
        n += n_dense * 3 * d * self.d_ff
        if self.n_experts:
            per_expert = 3 * d * self.d_ff_expert
            n += n_moe * (self.n_experts * per_expert
                          + self.n_shared_experts * per_expert
                          + d * self.n_experts)  # router
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        n_moe = self.n_layers - self.first_dense
        per_expert = 3 * self.d_model * self.d_ff_expert
        inactive = n_moe * (self.n_experts - self.top_k) * per_expert
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a dry-run cell applies to the arch, and why not (the JAX
    package's rule): long_500k only for the SSM and hybrid archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: full quadratic attention at 524k context; "
                       "long_500k runs only for SSM/hybrid archs")
    return True, ""


def config_from_jax(jcfg) -> ModelConfig:
    """The port's config for a JAX ``ModelConfig`` (read field by field;
    ``xla`` -> ``ref``, ``pallas`` -> ``kernel``)."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    kw["attn_impl"] = _FROM_JAX_IMPL[kw["attn_impl"]]
    kw["ssm_impl"] = _FROM_JAX_IMPL[kw["ssm_impl"]]
    return ModelConfig(**kw)

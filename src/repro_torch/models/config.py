"""Model configuration shared by all 10 architectures of the JAX package
(a copy of its `models/config.py`, every field kept, so that the configs
read the same)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 -> d_model // n_heads

    # --- attention variants --------------------------------------------------
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # gemma2 local layers (0 = full)
    alt_local_global: bool = False # gemma2: even layers local, odd global
    attn_softcap: float = 0.0      # gemma2 attention logit soft-cap
    final_softcap: float = 0.0     # gemma2 output logit soft-cap
    qk_norm: bool = False          # qwen3 / chameleon
    post_norms: bool = False       # gemma2 sandwich norms

    # --- MLA (deepseek-v2) ----------------------------------------------------
    mla_kv_lora: int = 0           # kv compression rank (0 = standard GQA)
    mla_q_lora: int = 0
    mla_rope_dim: int = 64
    mla_v_head: int = 128
    mla_qk_nope: int = 128

    # --- MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0               # per-expert hidden (d_ff used for dense FFN)
    n_shared_experts: int = 0      # deepseek shared experts (x moe_dff each)
    first_dense_layers: int = 0    # deepseek: leading dense layers
    capacity_factor: float = 1.25
    moe_dispatch: str = "flat"     # flat | nap | auto  (see repro/moe/README.md)
    wire_dtype: str = "f32"        # dispatch wire payload: f32 | bf16 | fp8_e4m3
                                   # ("f32" = identity codec, bit-identical)

    # --- SSM / hybrid -----------------------------------------------------------
    ssm_state: int = 0             # mamba2 N
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256           # SSD chunk length (TPU matmul form)
    shared_attn_every: int = 0     # zamba2: shared attn block period
    rwkv_head_size: int = 64
    rwkv_chunk: int = 0            # 0 = stepwise scan; >0 = chunked GLA form

    # --- encoder-decoder (whisper) ----------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 1500        # precomputed audio frame embeddings (stub)
    is_encoder_decoder: bool = False

    # --- embedding / head ---------------------------------------------------------
    tie_embeddings: bool = True
    embed_scale: bool = False      # gemma2 multiplies embeddings by sqrt(d)

    # --- numerics / execution ------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    attn_block_q: int = 1024       # blocked-attention tile sizes
    attn_block_kv: int = 1024
    xent_chunk: int = 2048         # chunked cross-entropy seq tile
    grad_accum: int = 1            # microbatches per train step
    use_pallas: bool = False       # opt-in Pallas decode kernel (TPU target)
    opt_state_dtype: str = "float32"   # "int8" -> 8-bit Adam moments
    opt_master_fp32: bool = True       # fp32 master copies of bf16 params
    sp_residuals: bool = True          # store residuals sequence-sharded (SP)

    # ------------------------------------------------------------------------
    def __post_init__(self) -> None:
        # fail at construction, not deep inside a traced dispatch
        dispatch_modes = ("flat", "nap", "auto")
        if self.moe_dispatch not in dispatch_modes:
            raise ValueError(
                f"moe_dispatch must be one of {'|'.join(dispatch_modes)}, "
                f"got {self.moe_dispatch!r}")
        wire_dtypes = ("f32", "bf16", "fp8_e4m3")
        if self.wire_dtype not in wire_dtypes:
            raise ValueError(
                f"wire_dtype must be one of {'|'.join(wire_dtypes)}, "
                f"got {self.wire_dtype!r}")

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Total parameter count (used for MODEL_FLOPS = 6 N D)."""
        return sum(_param_sizes(self))

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        return sum(_param_sizes(self, active_only=True))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _param_sizes(cfg: ModelConfig, active_only: bool = False):
    d, dh = cfg.d_model, cfg.head_dim
    yield cfg.vocab * d                                  # embedding
    if not cfg.tie_embeddings:
        yield cfg.vocab * d

    def attn_size() -> int:
        if cfg.mla_kv_lora:
            q_in = cfg.mla_q_lora or d
            size = 0
            if cfg.mla_q_lora:
                size += d * cfg.mla_q_lora
            size += q_in * cfg.n_heads * (cfg.mla_qk_nope + cfg.mla_rope_dim)
            size += d * (cfg.mla_kv_lora + cfg.mla_rope_dim)
            size += cfg.mla_kv_lora * cfg.n_heads * (cfg.mla_qk_nope + cfg.mla_v_head)
            size += cfg.n_heads * cfg.mla_v_head * d
            return size
        return (d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh
                + cfg.n_heads * dh * d)

    def dense_ffn(ff: int) -> int:
        return 3 * d * ff

    def layer_size(moe: bool) -> int:
        size = 2 * d  # norms
        if cfg.family == "ssm":      # rwkv6 block
            return rwkv_block_size(cfg)
        size += attn_size()
        if moe:
            n_routed = cfg.top_k if active_only else cfg.n_experts
            size += d * cfg.n_experts  # router (always resident)
            size += n_routed * dense_ffn(cfg.moe_dff) // 1
            size += cfg.n_shared_experts * dense_ffn(cfg.moe_dff)
        else:
            size += dense_ffn(cfg.d_ff)
        return size

    if cfg.family == "hybrid":       # zamba2
        yield cfg.n_layers * mamba_block_size(cfg)
        yield layer_size(False)      # one shared attention block
        return
    if cfg.family == "ssm":
        yield cfg.n_layers * rwkv_block_size(cfg)
        return
    n_moe = max(cfg.n_layers - cfg.first_dense_layers, 0) if cfg.is_moe else 0
    n_dense = cfg.n_layers - n_moe
    yield n_dense * layer_size(False) if not cfg.is_moe else n_dense * (
        2 * d + attn_size() + dense_ffn(cfg.d_ff if not cfg.is_moe else 12288))
    if n_moe:
        yield n_moe * layer_size(True)
    if cfg.is_encoder_decoder:
        # encoder layers + decoder cross-attention
        yield cfg.encoder_layers * (2 * d + attn_size() + dense_ffn(cfg.d_ff))
        yield cfg.n_layers * (d + attn_size())


def mamba_block_size(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n_heads = d_in // cfg.ssm_head_dim
    return (d * (2 * d_in + 2 * n_heads)          # in_proj (x, z) + dt, A bias
            + cfg.ssm_conv * d_in                 # conv
            + 2 * d_in * cfg.ssm_state            # B, C proj (grouped)
            + d_in * d                            # out proj
            + 2 * d)                              # norms


def rwkv_block_size(cfg: ModelConfig) -> int:
    d = cfg.d_model
    return (4 * d * d          # r, k, v, output of time mix
            + d * d            # gate
            + 6 * 32 * d * 2   # data-dependent decay LoRA (approx)
            + 2 * d * cfg.d_ff + d * cfg.d_ff  # channel mix (k, v, r)
            + 2 * d)

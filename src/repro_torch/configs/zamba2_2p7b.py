"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attn block
[arXiv:2411.15242; hf].  54 mamba layers, shared block every 6."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab=32_000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    shared_attn_every=6, tie_embeddings=True,
    grad_accum=4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                          d_head=16, d_ff=128, vocab=512,
                          ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
                          shared_attn_every=2,
                          attn_block_q=32, attn_block_kv=32, xent_chunk=32,
                          dtype="float32", remat=False)

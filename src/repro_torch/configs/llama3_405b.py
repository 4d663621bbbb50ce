"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_head=128,
    d_ff=53248, vocab=128_256,
    rope_theta=500_000.0, tie_embeddings=False,
    grad_accum=16,
    opt_state_dtype="int8", opt_master_fp32=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=8, n_kv_heads=2,
                          d_head=8, d_ff=192, vocab=512, grad_accum=2,
                          attn_block_q=32, attn_block_kv=32, xent_chunk=32,
                          dtype="float32", remat=False)

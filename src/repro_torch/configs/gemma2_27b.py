"""gemma2-27b [dense] — local+global alternating, logit softcap [arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=36864, vocab=256_000,
    sliding_window=4096, alt_local_global=True,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    embed_scale=True, tie_embeddings=True,
    grad_accum=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, vocab=512, sliding_window=16,
                          attn_block_q=32, attn_block_kv=32, xent_chunk=32,
                          dtype="float32", remat=False)

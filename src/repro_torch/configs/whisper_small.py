"""whisper-small [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

input_specs feeds precomputed frame embeddings [B, 1500, 768]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
    d_ff=3072, vocab=51_865,
    encoder_layers=12, encoder_seq=1500, is_encoder_decoder=True,
    tie_embeddings=True,
    grad_accum=4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_head=16, d_ff=128, vocab=512,
                          encoder_layers=2, encoder_seq=30,
                          attn_block_q=32, attn_block_kv=32, xent_chunk=32,
                          dtype="float32", remat=False)

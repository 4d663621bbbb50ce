"""chameleon-34b [vlm] — early-fusion, VQ image tokens (frontend stub: the
input is already a mixed text/image token stream), qk-norm
[arXiv:2405.09818; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab=65_536,
    qk_norm=True, tie_embeddings=False,
    grad_accum=8,
    opt_state_dtype="int8",  # 8-bit Adam moments (fp32 master kept)
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, vocab=512, grad_accum=1,
                          attn_block_q=32, attn_block_kv=32, xent_chunk=32,
                          dtype="float32", remat=False)

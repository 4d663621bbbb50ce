"""rwkv6-3b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,  # (attn-free)
    d_ff=8960, vocab=65_536,
    rwkv_head_size=64, tie_embeddings=True,
    grad_accum=4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=512, rwkv_head_size=16,
                          xent_chunk=32, dtype="float32", remat=False)

"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].  First layer dense (d_ff 12288)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=12288,              # dense (first) layer hidden
    vocab=102_400,
    mla_kv_lora=512, mla_q_lora=1536, mla_rope_dim=64,
    mla_v_head=128, mla_qk_nope=128,
    n_experts=160, top_k=6, moe_dff=1536, n_shared_experts=2,
    first_dense_layers=1, tie_embeddings=False,
    grad_accum=8,
    opt_state_dtype="int8",  # 8-bit Adam moments (fp32 master kept)
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                          d_head=16, d_ff=128, vocab=512,
                          mla_kv_lora=32, mla_q_lora=48, mla_rope_dim=8,
                          mla_v_head=16, mla_qk_nope=16,
                          n_experts=8, top_k=2, moe_dff=64,
                          n_shared_experts=1, first_dense_layers=1,
                          grad_accum=1, attn_block_q=32, attn_block_kv=32,
                          xent_chunk=32, dtype="float32", remat=False)

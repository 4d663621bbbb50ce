"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, qk-norm [hf:Qwen/Qwen3-235B-A22B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151_936,
    n_experts=128, top_k=8, moe_dff=1536,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=False,
    grad_accum=8,
    opt_state_dtype="int8",  # 8-bit Adam moments (fp32 master kept)
    # dispatch: flat vs nap resolved per geometry from the modeled
    # inter-pod bytes, bf16 payloads on the wire (repro_torch.moe)
    moe_dispatch="auto", wire_dtype="bf16",
)


def reduced() -> ModelConfig:
    # flat dispatch over an f32 wire: the deterministic baseline of the tests
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=96, vocab=512, n_experts=8, top_k=2,
                          moe_dff=96, grad_accum=1,
                          attn_block_q=32, attn_block_kv=32, xent_chunk=32,
                          dtype="float32", remat=False,
                          moe_dispatch="flat", wire_dtype="f32")

from repro_torch.kernels.decode_attn.kernel import decode_attention_grouped
from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_grouped", "decode_attention_ref"]

"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention + FFN
block, mirroring ``repro/models/zamba.py``.

``cfg.n_layers`` Mamba2 blocks run in segments of ``shared_attn_every``;
after each segment the one parameter-shared block is applied (9 times
for zamba2-2.7b's 54 / 6), with a KV cache of its own for each
application.  The Mamba2 state is O(1) in the context, so the shared
block's caches are the only memory that grows with it.

    ZambaModel(cfg, device).init(seed) | .load(tree)
    hidden(tokens [B, S])            -> [B, S, d] after the final norm
    loss({"tokens", "labels"})       -> mean token NLL (chunked_xent)
    prefill(tokens [B, S])           -> (last logits [B, V] float32, cache)
    init_cache(batch, max_seq)       -> {"mamba": {"h", "conv"} stacked over
                                        layers, "shared": {"k", "v"} stacked
                                        over applications, "length", "pos"}
    decode_step(cache, tokens [B,1]) -> (logits [B, 1, V] float32, cache)

Decode attention goes through ``attention.gqa_decode``: the CUDA kernel
on the card.  ``prefill`` returns the reference's cache as it is: the
shared block's k / v of the prompt and the Mamba states at their initial
zeros (the reference does not rebuild them).  Its caches are exactly S
long, and a full cache raises, so no decode continues from it; serving
teacher-forces the prompt through ``decode_step``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike
from repro_torch.models import attention as attn
from repro_torch.models.actsharding import ActShard
from repro_torch.models import ssm
from repro_torch.models.common import (chunked_xent, dtype_of, embed_init,
                                       head_logits, init_device, layer_call,
                                       rms_norm)
from repro_torch.models.ffn import ffn_apply, ffn_init
from repro_torch.models.params import TreeModel


def _mamba_layer(lp, cfg, x: torch.Tensor) -> torch.Tensor:
    return x + ssm.mamba2_apply(lp.mamba, cfg, rms_norm(x, lp.norm))


def _shared_attend(sp, cfg, x: torch.Tensor, cs_qkv=None):
    """The shared block over the full sequence, and the k, v it attended."""
    h, k, v = attn.gqa_attend(sp.attn, cfg, rms_norm(x, sp.norm1), cs_qkv=cs_qkv)
    x = x + h
    return x + ffn_apply(sp.ffn, rms_norm(x, sp.norm2)), k, v


def _shared_apply(sp, cfg, x: torch.Tensor, cs_qkv=None) -> torch.Tensor:
    return _shared_attend(sp, cfg, x, cs_qkv)[0]


class ZambaModel(TreeModel, ActShard):
    """The hybrid on one device (CUDA unless ``device="cpu"``);
    ``shard_mesh`` names the activation specs it reports while a counter
    is active (:mod:`repro_torch.models.actsharding`)."""

    def __init__(self, cfg, device: DeviceLike = None, *, shard_mesh: Any = None):
        super().__init__(cfg, device)
        self.shard_mesh = shard_mesh
        self.mamba_layers = nn.ModuleList()

    @property
    def n_apps(self) -> int:
        return self.cfg.n_layers // self.cfg.shared_attn_every

    def init_tree(self, gen: Optional[torch.Generator]) -> Dict[str, Any]:
        cfg = self.cfg
        dtype = dtype_of(cfg)
        ones = lambda: torch.ones((cfg.d_model,), dtype=dtype,  # noqa: E731
                                  device=init_device(gen))
        return {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
            "mamba_layers": [{"norm": ones(), "mamba": ssm.mamba2_init(gen, cfg, dtype)}
                             for _ in range(cfg.n_layers)],
            "shared": {"norm1": ones(), "attn": attn.gqa_init(gen, cfg, dtype),
                       "norm2": ones(),
                       "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype)},
            "final_norm": ones(),
        }

    def head_matrix(self) -> torch.Tensor:
        return self.embed.T

    def _segment(self, seg: int):
        per = self.cfg.shared_attn_every
        return range(seg * per, (seg + 1) * per)

    # ---- forward ------------------------------------------------------------
    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> hidden [B, S, d] (after the final norm)."""
        cfg = self.cfg
        x = F.embedding(tokens, self.embed)
        run = layer_call(cfg.remat)
        for seg in range(self.n_apps):
            for i in self._segment(seg):
                self.cs_params(self.mamba_layers[i])
                x = self.cs_full_hidden(x)
                x = self.cs_hidden(run(_mamba_layer, self.mamba_layers[i], cfg, x))
            x = run(_shared_apply, self.shared, cfg, x, self.cs_qkv)
        return rms_norm(x, self.final_norm)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean token NLL of ``batch["labels"]`` (-1 ignored), float32."""
        h = self.hidden(batch["tokens"])
        return chunked_xent(h, self.head_matrix(), batch["labels"],
                            chunk=self.cfg.xent_chunk, cs_logits=self.cs_logits)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """The prompt in one pass: (logits of the last position [B, V]
        float32, the reference's cache: the shared block's ``k`` / ``v``
        ``[n_apps, B, S, Hkv, dh]``, the Mamba states at zero, ``length``
        = S and the host's ``pos`` = S)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = F.embedding(tokens, self.embed)
        ks, vs = [], []
        for seg in range(self.n_apps):
            for i in self._segment(seg):
                x = _mamba_layer(self.mamba_layers[i], cfg, x)
            x, k, v = _shared_attend(self.shared, cfg, x, self.cs_qkv)
            ks.append(k)
            vs.append(v)
        x = rms_norm(x, self.final_norm)
        logits = head_logits(x[:, -1], self.head_matrix())
        cache = self._mamba_cache(b)
        cache.update(shared={"k": torch.stack(ks), "v": torch.stack(vs)},
                     length=torch.full((b,), s, dtype=torch.int32, device=x.device),
                     pos=s)
        return logits, cache

    # ---- serving ------------------------------------------------------------
    def _mamba_cache(self, batch: int) -> Dict[str, Any]:
        cfg = self.cfg
        one = ssm.mamba2_init_state(cfg, batch, dtype_of(cfg), self.device)
        return {"mamba": {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=v.dtype,
                                         device=v.device) for k, v in one.items()}}

    def init_cache(self, batch: int, max_seq: int) -> Dict:
        """Zero states and caches: ``mamba`` ``h [L, B, H, P, N]`` float32
        and ``conv [L, B, conv - 1, d_in]``, ``shared`` ``k`` / ``v``
        ``[n_apps, B, max_seq, Hkv, dh]``, the per-sequence ``length`` on
        the device and its host copy ``pos``."""
        cfg = self.cfg
        shape = (self.n_apps, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        cache = self._mamba_cache(batch)
        cache.update(shared={k: torch.zeros(shape, dtype=dtype_of(cfg), device=self.device)
                             for k in ("k", "v")},
                     length=torch.zeros((batch,), dtype=torch.int32, device=self.device),
                     pos=0)
        return cache

    @torch.no_grad()
    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B, 1] -> (logits [B, 1, V] float32, cache).  The states
        and the shared block's caches are updated in place and returned;
        ``length`` and ``pos`` advance by one."""
        cfg = self.cfg
        length, pos = cache["length"], cache["pos"]
        states, shared = cache["mamba"], cache["shared"]
        x = F.embedding(tokens, self.embed)
        sp = self.shared
        for seg in range(self.n_apps):
            for i in self._segment(seg):
                lp = self.mamba_layers[i]
                y, st = ssm.mamba2_decode(lp.mamba, cfg, rms_norm(x, lp.norm),
                                          {k: v[i] for k, v in states.items()})
                x = x + y
                for k, v in st.items():
                    states[k][i] = v
            y, _ = attn.gqa_decode(sp.attn, cfg, rms_norm(x, sp.norm1),
                                   {k: v[seg] for k, v in shared.items()}, length, pos=pos)
            x = x + y
            x = x + ffn_apply(sp.ffn, rms_norm(x, sp.norm2))
        cache["length"] = length + 1
        cache["pos"] = pos + 1
        x = rms_norm(x, self.final_norm)
        return head_logits(x, self.head_matrix()), cache

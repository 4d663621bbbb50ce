"""Whisper-style encoder-decoder backbone (the audio family), mirroring
``repro/models/whisper.py``.

The conv audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``[B, encoder_seq, d]`` (what the two conv
layers would produce).  Positions are sinusoidal for both stacks.

    WhisperModel(cfg, device).init(seed) | .load(tree)
    encode(frames [B, T, d])          -> encoder hidden [B, T, d]
    hidden(tokens [B, S], enc)        -> decoder hidden [B, S, d]
    loss({"tokens", "labels", "frames"}) -> mean token NLL
    prefill(tokens, frames)           -> (last logits [B, V] float32, cache)
    cross_cache(frames)               -> {"xk", "xv"} [L, B, T, Hkv, dh]
    init_cache(batch, max_seq)        -> {"layers": {"k", "v"}, "xk", "xv",
                                         "length", "pos"}
    decode_step(cache, tokens [B, 1]) -> (logits [B, 1, V] float32, cache)

Decoding reaches the decode kernel twice a layer: the self-attention
through ``attention.gqa_decode``, and the cross-attention through
``decode_attention_grouped`` on the ``xk`` / ``xv`` caches read in place
(``encoder_seq`` rows each, where the reference calls the jnp twin of its
Pallas kernel, ``cache_decode_attention``).  ``cross_cache`` builds the
cross caches exactly as the reference's ``prefill`` does, so a server
can fill them before it teacher-forces a prompt (``launch.serve``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike
from repro_torch.kernels.decode_attn.kernel import decode_attention_grouped
from repro_torch.models import attention as attn
from repro_torch.models.actsharding import ActShard
from repro_torch.models.common import (blocked_attention, chunked_xent,
                                       dense_init, dtype_of, embed_init,
                                       head_logits, init_device, layer_call,
                                       rms_norm)
from repro_torch.models.ffn import ffn_apply, ffn_init
from repro_torch.models.params import TreeModel


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions [...]-shaped int -> [..., d] float32 sinusoids."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=positions.device) / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _xattn_init(gen: Optional[torch.Generator], cfg, dtype) -> Dict[str, torch.Tensor]:
    d, dh = cfg.d_model, cfg.head_dim
    return {"wq": dense_init(gen, d, cfg.n_heads * dh, dtype),
            "wk": dense_init(gen, d, cfg.n_kv_heads * dh, dtype),
            "wv": dense_init(gen, d, cfg.n_kv_heads * dh, dtype),
            "wo": dense_init(gen, cfg.n_heads * dh, d, dtype)}


def _xattn_kv(p, cfg, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's cross-attention k, v [B, T, Hkv, dh]."""
    b, t, _ = enc.shape
    dh, hkv = cfg.head_dim, cfg.n_kv_heads
    return ((enc @ p["wk"]).reshape(b, t, hkv, dh),
            (enc @ p["wv"]).reshape(b, t, hkv, dh))


def _xattn_apply(p, cfg, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of x [B, S, d] over k, v (no mask) -> [B, S, d]."""
    b, s, _ = x.shape
    dh, hkv = cfg.head_dim, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(b, s, hkv, cfg.n_heads // hkv, dh)
    out = blocked_attention(q, k, v, causal=False, block_q=cfg.attn_block_q,
                            block_kv=cfg.attn_block_kv)
    return out.reshape(b, s, -1) @ p["wo"]


def _enc_layer(lp, cfg, x: torch.Tensor, cs_qkv=None) -> torch.Tensor:
    x = x + attn.gqa_apply(lp.attn, cfg, rms_norm(x, lp.norm1), causal=False,
                           cs_qkv=cs_qkv)
    return x + ffn_apply(lp.ffn, rms_norm(x, lp.norm2), act="gelu")


def _dec_layer(lp, cfg, x: torch.Tensor, enc: torch.Tensor, cs_qkv=None):
    """One decoder layer over the full sequence, and its caches: the
    self-attention's k, v and the cross-attention's xk, xv."""
    h, k, v = attn.gqa_attend(lp.attn, cfg, rms_norm(x, lp.norm1), cs_qkv=cs_qkv)
    x = x + h
    xk, xv = _xattn_kv(lp.xattn, cfg, enc)
    x = x + _xattn_apply(lp.xattn, cfg, rms_norm(x, lp.norm_x), xk, xv)
    x = x + ffn_apply(lp.ffn, rms_norm(x, lp.norm2), act="gelu")
    return x, {"k": k, "v": v, "xk": xk, "xv": xv}


def _dec_apply(lp, cfg, x: torch.Tensor, enc: torch.Tensor,
               cs_qkv=None) -> torch.Tensor:
    return _dec_layer(lp, cfg, x, enc, cs_qkv)[0]


class WhisperModel(TreeModel, ActShard):
    """The encoder-decoder on one device (CUDA unless ``device="cpu"``);
    ``shard_mesh`` names the activation specs it reports while a counter
    is active (:mod:`repro_torch.models.actsharding`)."""

    def __init__(self, cfg, device: DeviceLike = None, *, shard_mesh: Any = None):
        super().__init__(cfg, device)
        self.shard_mesh = shard_mesh
        self.enc_layers = nn.ModuleList()
        self.dec_layers = nn.ModuleList()

    def init_tree(self, gen: Optional[torch.Generator]) -> Dict[str, Any]:
        cfg = self.cfg
        dtype = dtype_of(cfg)
        d = cfg.d_model
        ones = lambda: torch.ones((d,), dtype=dtype, device=init_device(gen))  # noqa: E731

        def enc_layer():
            return {"norm1": ones(), "attn": attn.gqa_init(gen, cfg, dtype),
                    "norm2": ones(), "ffn": ffn_init(gen, d, cfg.d_ff, dtype)}

        def dec_layer():
            return {"norm1": ones(), "attn": attn.gqa_init(gen, cfg, dtype),
                    "norm_x": ones(), "xattn": _xattn_init(gen, cfg, dtype),
                    "norm2": ones(), "ffn": ffn_init(gen, d, cfg.d_ff, dtype)}

        return {
            "embed": embed_init(gen, cfg.vocab, d, dtype),
            "enc_layers": [enc_layer() for _ in range(cfg.encoder_layers)],
            "enc_norm": ones(),
            "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
            "final_norm": ones(),
        }

    def head_matrix(self) -> torch.Tensor:
        return self.embed.T

    def _embed(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, self.embed)
        return x + sinusoidal(positions, self.cfg.d_model).to(x.dtype)

    # ---- encoder ------------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, T, d] (the stubbed conv output) -> encoder hidden."""
        cfg = self.cfg
        x = frames.to(device=self.device, dtype=dtype_of(cfg))
        x = x + sinusoidal(torch.arange(x.shape[1], device=x.device),
                           cfg.d_model).to(x.dtype)[None]
        run = layer_call(self.cfg.remat)
        for lp in self.enc_layers:
            self.cs_params(lp)
            x = self.cs_full_hidden(x)
            x = self.cs_hidden(run(_enc_layer, lp, cfg, x, self.cs_qkv))
        return rms_norm(x, self.enc_norm)

    # ---- decoder (training) ---------------------------------------------------
    def hidden(self, tokens: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] over the encoder output -> [B, S, d] after the
        final norm."""
        x = self._embed(tokens, torch.arange(tokens.shape[1], device=tokens.device)[None])
        run = layer_call(self.cfg.remat)
        for lp in self.dec_layers:
            self.cs_params(lp)
            x = self.cs_full_hidden(x)
            x = self.cs_hidden(run(_dec_apply, lp, self.cfg, x, enc, self.cs_qkv))
        return rms_norm(x, self.final_norm)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean token NLL of ``batch["labels"]`` (-1 ignored) given
        ``batch["frames"]``, float32."""
        h = self.hidden(batch["tokens"], self.encode(batch["frames"]))
        return chunked_xent(h, self.head_matrix(), batch["labels"],
                            chunk=self.cfg.xent_chunk, cs_logits=self.cs_logits)

    # ---- serving ------------------------------------------------------------
    @torch.no_grad()
    def cross_cache(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The cross-attention caches of ``frames``: each decoder layer's
        ``_xattn_kv`` of the encoder output, stacked into ``xk`` / ``xv``
        ``[L, B, T, Hkv, dh]`` (the reference's ``prefill`` builds them so)."""
        enc = self.encode(frames)
        kv = [_xattn_kv(lp.xattn, self.cfg, enc) for lp in self.dec_layers]
        return {"xk": torch.stack([k for k, _ in kv]), "xv": torch.stack([v for _, v in kv])}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, frames: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
        """The prompt over ``frames`` in one pass: (logits of the last
        position [B, V] float32, the cache: ``layers`` ``k`` / ``v`` and
        ``xk`` / ``xv`` ``[L, B, S | T, Hkv, dh]``, ``length`` = S, ``pos``
        = S)."""
        cfg = self.cfg
        b, s = tokens.shape
        enc = self.encode(frames)
        x = self._embed(tokens, torch.arange(s, device=tokens.device)[None])
        caches = []
        for lp in self.dec_layers:
            x, c = _dec_layer(lp, cfg, x, enc, self.cs_qkv)
            for k in sorted(c):
                self.cs_kv(c[k])
            x = self.cs_hidden(x)
            caches.append(c)
        x = rms_norm(x, self.final_norm)
        logits = head_logits(x[:, -1], self.head_matrix())
        stacked = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
        cache = {"layers": {"k": stacked["k"], "v": stacked["v"]},
                 "xk": stacked["xk"], "xv": stacked["xv"],
                 "length": torch.full((b,), s, dtype=torch.int32, device=x.device),
                 "pos": s}
        return logits, cache

    def init_cache(self, batch: int, max_seq: int) -> Dict:
        """Zero caches: the self-attention's ``layers`` ``k`` / ``v`` ``[L,
        B, max_seq, Hkv, dh]``, the cross-attention's ``xk`` / ``xv`` ``[L,
        B, encoder_seq, Hkv, dh]`` (fill them from ``cross_cache``), the
        per-sequence ``length`` on the device and its host copy ``pos``."""
        cfg = self.cfg
        zeros = lambda s: torch.zeros((cfg.n_layers, batch, s, cfg.n_kv_heads,  # noqa: E731
                                       cfg.head_dim), dtype=dtype_of(cfg),
                                      device=self.device)
        return {"layers": {"k": zeros(max_seq), "v": zeros(max_seq)},
                "xk": zeros(cfg.encoder_seq), "xv": zeros(cfg.encoder_seq),
                "length": torch.zeros((batch,), dtype=torch.int32, device=self.device),
                "pos": 0}

    @torch.no_grad()
    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B, 1] -> (logits [B, 1, V] float32, cache).  The
        self-attention caches are updated in place (``gqa_decode``) and
        returned; ``length`` and ``pos`` advance by one."""
        cfg = self.cfg
        b = tokens.shape[0]
        length, pos = cache["length"], cache["pos"]
        dh, hkv = cfg.head_dim, cfg.n_kv_heads
        enc_len = torch.full((b,), cfg.encoder_seq, dtype=torch.int32, device=length.device)
        x = self._embed(tokens, length[:, None])
        for i, lp in enumerate(self.dec_layers):
            y, _ = attn.gqa_decode(lp.attn, cfg, rms_norm(x, lp.norm1),
                                   {k: v[i] for k, v in cache["layers"].items()},
                                   length, pos=pos)
            x = x + y
            q = (rms_norm(x, lp.norm_x) @ lp.xattn["wq"]).reshape(b, hkv, -1, dh)
            y = decode_attention_grouped(q, cache["xk"][i].transpose(1, 2),
                                         cache["xv"][i].transpose(1, 2), enc_len,
                                         scale=1.0 / math.sqrt(dh),
                                         span=cfg.encoder_seq)
            x = x + y.to(x.dtype).reshape(b, 1, -1) @ lp.xattn["wo"]
            x = x + ffn_apply(lp.ffn, rms_norm(x, lp.norm2), act="gelu")
        cache["length"] = length + 1
        cache["pos"] = pos + 1
        x = rms_norm(x, self.final_norm)
        return head_logits(x, self.head_matrix()), cache

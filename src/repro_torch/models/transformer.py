"""Decoder-only LM of the dense GQA family, for serving.

Mirrors ``repro/models/transformer.py``: the same parameter tree (layers
as a list instead of a leading stacked axis), the same per-layer windows,
and a Python loop over an ``nn.ModuleList`` where the reference scans.

    LM(cfg, device).init(seed)       -> the model, weights from a Generator
    LM(cfg, device).load(tree)       -> the model, weights from a tree
                                        (``models.convert.params_from_jax``)
    init_cache(batch, max_seq)       -> {"layers": {"k", "v"}, "length", "pos"}
    decode_step(cache, tokens [B,1]) -> (logits [B, 1, V] float32, cache)

``hidden``, ``loss`` and ``prefill``, and the MoE, MLA, SSM, hybrid and
encoder-decoder families, wait for their slices (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       head_logits, rms_norm)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn_apply, ffn_init


def unported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet, or None for the dense family."""
    if cfg.is_encoder_decoder:
        return "the encoder-decoder family (ROADMAP Queue 1 item 7e)"
    if cfg.family == "hybrid":
        return "the hybrid SSM family (ROADMAP Queue 1 item 7f)"
    if cfg.family == "ssm":
        return "the RWKV SSM family (ROADMAP Queue 1 item 7g)"
    if cfg.is_moe or cfg.mla_kv_lora:
        return ("the LM with MoE blocks and MLA attention (ROADMAP Queue 1 "
                "item 7d; the MoE layer itself is repro_torch.moe)")
    return None


# ---------------------------------------------------------------------------
# single transformer block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, dtype, *, d_ff: int) -> Dict:
    norm = torch.zeros if cfg.post_norms else torch.ones
    d = cfg.d_model
    p = {"norm1": norm((d,), dtype=dtype, device=gen.device),
         "norm2": norm((d,), dtype=dtype, device=gen.device)}
    if cfg.post_norms:  # gemma2 sandwich norms (stored as w-1 -> zeros)
        p["norm1_post"] = torch.zeros((d,), dtype=dtype, device=gen.device)
        p["norm2_post"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    p["attn"] = attn.gqa_init(gen, cfg, dtype)
    p["ffn"] = ffn_init(gen, d, d_ff, dtype)
    return p


def _norm(cfg, x, w):
    return rms_norm(x, w, plus_one=cfg.post_norms)


def block_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                 length: torch.Tensor, *, pos: int,
                 window: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    h = _norm(cfg, x, p.norm1)
    h, cache = attn.gqa_decode(p.attn, cfg, h, cache, length, pos=pos,
                               window=window)
    if cfg.post_norms:
        h = _norm(cfg, h, p.norm1_post)
    x = x + h
    h = ffn_apply(p.ffn, _norm(cfg, x, p.norm2))
    if cfg.post_norms:
        h = _norm(cfg, h, p.norm2_post)
    return x + h, cache


def _layer_windows(cfg: ModelConfig, n_layers: int, max_seq: int) -> List[int]:
    """Per-layer attention window (gemma2: even layers local, odd layers
    ``max_seq``, which masks nothing)."""
    if cfg.alt_local_global and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else max_seq
                for i in range(n_layers)]
    return [max_seq] * n_layers


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer's parameters: ``norm*`` tensors, and ``attn`` and ``ffn``
    dictionaries keyed as in the reference (``p.attn["wq"]``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, t in tree.items():
            if isinstance(t, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: _frozen(v) for k, v in t.items()}))
            else:
                self.register_parameter(name, _frozen(t))


# ---------------------------------------------------------------------------
# LM model object
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """Dense decoder-only LM on one device (CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        reason = unported_reason(cfg)
        if reason:
            raise NotImplementedError(f"{cfg.name}: not ported yet; it needs {reason}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.layers = nn.ModuleList()

    # ---- params -------------------------------------------------------------
    def init(self, seed: Union[int, torch.Generator] = 0) -> "LM":
        """Random weights drawn on the model's device, in the reference's
        order (embed, head, layers); a Generator or a seed for one."""
        cfg = self.cfg
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(seed)
        dtype = dtype_of(cfg)
        tree: Dict[str, Any] = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
            "final_norm": (torch.zeros if cfg.post_norms else torch.ones)(
                (cfg.d_model,), dtype=dtype, device=gen.device),
        }
        if not cfg.tie_embeddings:
            tree["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype)
        tree["layers"] = [block_init(gen, cfg, dtype, d_ff=cfg.d_ff)
                          for _ in range(cfg.n_layers)]
        return self.load(tree)

    def load(self, tree: Dict[str, Any]) -> "LM":
        """Take a parameter tree ({"embed", "final_norm", ["head"],
        "layers": [block trees]}), moved to the model's device and dtype."""
        dtype = dtype_of(self.cfg)
        move = lambda t: t.to(device=self.device, dtype=dtype)  # noqa: E731
        if len(tree["layers"]) != self.cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers for a config of "
                             f"{self.cfg.n_layers}")
        for name in ("embed", "final_norm", "head"):
            if name in tree:
                self.register_parameter(name, _frozen(move(tree[name])))
        self.layers = nn.ModuleList(
            Block({k: ({n: move(t) for n, t in v.items()} if isinstance(v, dict)
                       else move(v)) for k, v in lp.items()})
            for lp in tree["layers"])
        return self

    def head_matrix(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed.T
        return self.head

    # ---- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> Dict:
        """Zero caches stacked over layers, ``[L, B, S, Hkv, D]`` each, the
        per-sequence ``length`` on the device and its host copy ``pos``."""
        one = attn.gqa_init_cache(self.cfg, batch, max_seq, dtype_of(self.cfg),
                                  self.device)
        layers = {k: torch.zeros((self.cfg.n_layers,) + v.shape, dtype=v.dtype,
                                 device=v.device) for k, v in one.items()}
        return {"layers": layers,
                "length": torch.zeros((batch,), dtype=torch.int32, device=self.device),
                "pos": 0}

    @torch.no_grad()
    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B, 1] -> (logits [B, 1, V] float32, cache).

        The cache is updated in place (see ``attention.gqa_decode``) and
        returned; ``length`` and ``pos`` advance by one.
        """
        cfg = self.cfg
        length, pos = cache["length"], cache["pos"]
        x = F.embedding(tokens, self.embed)
        if cfg.embed_scale:
            # sqrt(d) rounded to the weights' dtype, as the reference does
            x = x * torch.tensor(math.sqrt(cfg.d_model)).to(x.dtype).item()
        ks, vs = cache["layers"]["k"], cache["layers"]["v"]
        windows = _layer_windows(cfg, cfg.n_layers, ks.shape[2])
        has_window = bool(cfg.alt_local_global and cfg.sliding_window)
        for i, lp in enumerate(self.layers):
            x, _ = block_decode(lp, cfg, x, {"k": ks[i], "v": vs[i]}, length,
                                pos=pos, window=windows[i] if has_window else None)
        cache["length"] = length + 1
        cache["pos"] = pos + 1
        x = _norm(cfg, x, self.final_norm)
        return head_logits(x, self.head_matrix(), cfg.final_softcap), cache

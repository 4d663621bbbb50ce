"""Decoder-only LM of the dense GQA family: training, prefill and decoding.

Mirrors ``repro/models/transformer.py``: the same parameter tree (layers
as a list instead of a leading stacked axis), the same per-layer windows,
and a Python loop over an ``nn.ModuleList`` where the reference scans;
``cfg.remat`` checkpoints each layer (``torch.utils.checkpoint``) where
the reference wraps its scan body in ``jax.checkpoint``.

    LM(cfg, device).init(seed)       -> the model, weights from a Generator
    LM(cfg, device).load(tree)       -> the model, weights copied from a tree
                                        (``models.convert.params_from_jax``)
    param_tree()                     -> the trainable weights as that tree
    hidden(tokens [B, S])            -> [B, S, d] after the final norm
    loss({"tokens", "labels"})       -> mean token NLL (chunked_xent)
    prefill(tokens [B, S])           -> (last logits [B, V] float32, cache
                                        filled to S)
    init_cache(batch, max_seq)       -> {"layers": {"k", "v"}, "length", "pos"}
    decode_step(cache, tokens [B,1]) -> (logits [B, 1, V] float32, cache)

The MoE, MLA, SSM, hybrid and encoder-decoder families wait for their
slices (ROADMAP Queue 1 items 7d-7g).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (chunked_xent, dense_init, dtype_of,
                                       embed_init, head_logits, init_device,
                                       rms_norm)
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

def block_init(gen: Optional[torch.Generator], cfg: ModelConfig, dtype, *,
               d_ff: int) -> Dict:
    norm = torch.zeros if cfg.post_norms else torch.ones
    d, dev = cfg.d_model, init_device(gen)
    p = {"norm1": norm((d,), dtype=dtype, device=dev),
         "norm2": norm((d,), dtype=dtype, device=dev)}
    if cfg.post_norms:  # gemma2 sandwich norms (stored as w-1 -> zeros)
        p["norm1_post"] = torch.zeros((d,), dtype=dtype, device=dev)
        p["norm2_post"] = torch.zeros((d,), dtype=dtype, device=dev)
    p["attn"] = attn.gqa_init(gen, cfg, dtype)
    p["ffn"] = ffn_init(gen, d, d_ff, dtype)
    return p


def _norm(cfg, x, w):
    return rms_norm(x, w, plus_one=cfg.post_norms)


def _act(cfg) -> str:
    return "gelu" if cfg.family == "audio" else "silu"


def _ffn_half(p, cfg, x):
    """The block's second residual branch: norm, FFN, post-norm."""
    h = ffn_apply(p.ffn, _norm(cfg, x, p.norm2), act=_act(cfg))
    if cfg.post_norms:
        h = _norm(cfg, h, p.norm2_post)
    return x + h


def block_prefill(p, cfg: ModelConfig, x: torch.Tensor, *,
                  window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer over the full sequence, and its cache ``{"k", "v"}`` of
    ``[B, S, Hkv, dh]`` (the reference's ``LM._prefill_block``)."""
    h, k, v = attn.gqa_attend(p.attn, cfg, _norm(cfg, x, p.norm1), window=window)
    if cfg.post_norms:
        h = _norm(cfg, h, p.norm1_post)
    return _ffn_half(p, cfg, x + h), {"k": k, "v": v}


def block_apply(p, cfg: ModelConfig, x: torch.Tensor, *,
                window: Optional[int] = None) -> torch.Tensor:
    """One layer over the full sequence (training)."""
    return block_prefill(p, cfg, x, window=window)[0]


def block_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                 length: torch.Tensor, *, pos: int,
                 window: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    h = _norm(cfg, x, p.norm1)
    h, cache = attn.gqa_decode(p.attn, cfg, h, cache, length, pos=pos,
                               window=window)
    if cfg.post_norms:
        h = _norm(cfg, h, p.norm1_post)
    return _ffn_half(p, cfg, x + h), cache


def _layer_windows(cfg: ModelConfig, n_layers: int, max_seq: int) -> List[int]:
    """Per-layer attention window (gemma2: even layers local, odd layers
    ``max_seq``, which masks nothing)."""
    if cfg.alt_local_global and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else max_seq
                for i in range(n_layers)]
    return [max_seq] * n_layers


class Block(nn.Module):
    """One layer's parameters: ``norm*`` tensors, and ``attn`` and ``ffn``
    dictionaries keyed as in the reference (``p.attn["wq"]``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, t in tree.items():
            if isinstance(t, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: nn.Parameter(v) for k, v in t.items()}))
            else:
                self.register_parameter(name, nn.Parameter(t))

    def tree(self) -> Dict[str, Any]:
        """The layer's parameters as the reference's block tree."""
        return {name: (dict(m.items()) if isinstance(m, nn.ParameterDict) else m)
                for name, m in list(self.named_parameters(recurse=False))
                + list(self.named_children())}


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
    def init_tree(self, gen: Optional[torch.Generator]) -> Dict[str, Any]:
        """A parameter tree drawn from ``gen`` in the reference's order
        (embed, head, layers), on the generator's device; with no
        generator, meta tensors of the same shapes and dtypes."""
        cfg = self.cfg
        dtype = dtype_of(cfg)
        tree: Dict[str, Any] = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
            "final_norm": (torch.zeros if cfg.post_norms else torch.ones)(
                (cfg.d_model,), dtype=dtype, device=init_device(gen)),
        }
        if not cfg.tie_embeddings:
            tree["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype)
        tree["layers"] = [block_init(gen, cfg, dtype, d_ff=cfg.d_ff)
                          for _ in range(cfg.n_layers)]
        return tree

    def init(self, seed: Union[int, torch.Generator] = 0) -> "LM":
        """Random weights drawn on the model's device; a Generator or a
        seed for one."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(seed)
        return self._set(self.init_tree(gen), copy=False)

    def load(self, tree: Dict[str, Any]) -> "LM":
        """Take a parameter tree ({"embed", "final_norm", ["head"],
        "layers": [block trees]}), copied to the model's device and dtype
        (training updates the weights in place; the caller's tree stays
        as it was)."""
        return self._set(tree, copy=True)

    def _set(self, tree: Dict[str, Any], copy: bool) -> "LM":
        dtype = dtype_of(self.cfg)
        move = lambda t: t.to(device=self.device, dtype=dtype, copy=copy)  # noqa: E731
        if len(tree["layers"]) != self.cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers for a config of "
                             f"{self.cfg.n_layers}")
        for name in ("embed", "final_norm", "head"):
            if name in tree:
                self.register_parameter(name, nn.Parameter(move(tree[name])))
        self.layers = nn.ModuleList(
            Block({k: ({n: move(t) for n, t in v.items()} if isinstance(v, dict)
                       else move(v)) for k, v in lp.items()})
            for lp in tree["layers"])
        return self

    def param_tree(self) -> Dict[str, Any]:
        """The weights (``nn.Parameter``s, trainable) as the reference's
        tree with the layers as a list: what ``optim.adamw`` and the
        checkpoints walk."""
        tree: Dict[str, Any] = {name: getattr(self, name) for name in
                                ("embed", "final_norm", "head") if hasattr(self, name)}
        tree["layers"] = [lp.tree() for lp in self.layers]
        return tree

    def head_matrix(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed.T
        return self.head

    # ---- forward ------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, self.embed)
        if self.cfg.embed_scale:
            # sqrt(d) rounded to the weights' dtype, as the reference does
            x = x * torch.tensor(math.sqrt(self.cfg.d_model)).to(x.dtype).item()
        return x

    def _windows(self, seq: int) -> List[Optional[int]]:
        """Each layer's window for a sequence of ``seq`` (None: no window)."""
        cfg = self.cfg
        if not (cfg.alt_local_global and cfg.sliding_window):
            return [None] * cfg.n_layers
        return _layer_windows(cfg, cfg.n_layers, seq)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> hidden [B, S, d] (after the final norm)."""
        cfg = self.cfg
        x = self._embed(tokens)
        remat = cfg.remat and torch.is_grad_enabled()
        for lp, w in zip(self.layers, self._windows(tokens.shape[1])):
            x = (checkpoint(block_apply, lp, cfg, x, window=w, use_reentrant=False)
                 if remat else block_apply(lp, cfg, x, window=w))
        return _norm(cfg, x, self.final_norm)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean token NLL of ``batch["labels"]`` (-1 ignored), float32."""
        h = self.hidden(batch["tokens"])
        return chunked_xent(h, self.head_matrix(), batch["labels"],
                            chunk=self.cfg.xent_chunk,
                            softcap=self.cfg.final_softcap)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """The prompt in one pass: (logits of the last position [B, V]
        float32, the cache filled to S).  The cache is the reference's,
        ``k`` and ``v`` of ``[L, B, S, Hkv, dh]`` and ``length`` = S, plus
        the host's ``pos`` = S."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed(tokens)
        ks, vs = [], []
        for lp, w in zip(self.layers, self._windows(s)):
            x, c = block_prefill(lp, cfg, x, window=w)
            ks.append(c["k"])
            vs.append(c["v"])
        x = _norm(cfg, x, self.final_norm)
        logits = head_logits(x[:, -1], self.head_matrix(), cfg.final_softcap)
        cache = {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)},
                 "length": torch.full((b,), s, dtype=torch.int32, device=x.device),
                 "pos": s}
        return logits, cache

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
        x = self._embed(tokens)
        ks, vs = cache["layers"]["k"], cache["layers"]["v"]
        for i, (lp, w) in enumerate(zip(self.layers, self._windows(ks.shape[2]))):
            x, _ = block_decode(lp, cfg, x, {"k": ks[i], "v": vs[i]}, length,
                                pos=pos, window=w)
        cache["length"] = length + 1
        cache["pos"] = pos + 1
        x = _norm(cfg, x, self.final_norm)
        return head_logits(x, self.head_matrix(), cfg.final_softcap), cache

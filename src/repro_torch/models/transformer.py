"""Decoder-only LM: the dense GQA family, the MoE family (qwen3-moe's
GQA + MoE blocks; deepseek-v2's MLA attention, shared experts and dense
first layer) and the SSM family (rwkv6's attention-free blocks, which
the reference also assembles here): training, prefill and decoding.

Mirrors ``repro/models/transformer.py``: the same parameter tree (layers
as a list instead of a leading stacked axis; deepseek's leading dense
layers under ``dense_layers``), the same per-layer windows, and a Python
loop over an ``nn.ModuleList`` where the reference scans; ``cfg.remat``
checkpoints each layer (``torch.utils.checkpoint``) where the reference
wraps its scan body in ``jax.checkpoint``.

    LM(cfg, device).init(seed)       -> the model, weights from a Generator
    LM(cfg, device).load(tree)       -> the model, weights copied from a tree
                                        (``models.convert.params_from_jax``)
    param_tree()                     -> the trainable weights as that tree
    hidden(tokens [B, S])            -> [B, S, d] after the final norm
    loss({"tokens", "labels"})       -> mean token NLL (chunked_xent)
    prefill(tokens [B, S])           -> (last logits [B, V] float32, cache
                                        filled to S)
    init_cache(batch, max_seq)       -> {"layers": {"k", "v"} or {"c_kv",
                                        "k_rope"}, ["dense_layers"],
                                        "length", "pos"}; the SSM family's
                                        {"state": {"S", "last_x",
                                        "last_x_c"}, "length", "pos"}
    decode_step(cache, tokens [B,1]) -> (logits [B, 1, V] float32, cache)

MoE blocks run ``moe_apply_local`` (the dense-masked oracle, in chunks of
``MOE_CHUNK`` tokens) without a mesh, and the expert-parallel island
``moe_apply_sharded`` with ``mesh=`` a ``Topology`` or a
``ProcessMesh``, as the reference's ``LM(mesh=, ep=)``.  The hybrid and
encoder-decoder families are ``models.zamba`` and ``models.whisper``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike
from repro_torch.models import attention as attn
from repro_torch.models import rwkv
from repro_torch.models.actsharding import ActShard
from repro_torch.models.common import (chunked_xent, dense_init, dtype_of,
                                       embed_init, head_logits, init_device,
                                       rms_norm)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import ffn_apply, ffn_init
from repro_torch.models.moe import (EPInfo, moe_apply_local,
                                    moe_apply_sharded, moe_init)
from repro_torch.models.params import TreeModel

# tokens of the dense-masked MoE oracle computed at once: every expert on
# every token, [chunk, E, moe_dff] and [chunk, E, d] intermediates
MOE_CHUNK = 256

MoEFn = Callable[[Any, torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# single transformer block (dense or moe)
# ---------------------------------------------------------------------------

def block_init(gen: Optional[torch.Generator], cfg: ModelConfig, dtype, *,
               moe: bool = False, d_ff: int) -> Dict:
    norm = torch.zeros if cfg.post_norms else torch.ones
    d, dev = cfg.d_model, init_device(gen)
    p = {"norm1": norm((d,), dtype=dtype, device=dev),
         "norm2": norm((d,), dtype=dtype, device=dev)}
    if cfg.post_norms:  # gemma2 sandwich norms (stored as w-1 -> zeros)
        p["norm1_post"] = torch.zeros((d,), dtype=dtype, device=dev)
        p["norm2_post"] = torch.zeros((d,), dtype=dtype, device=dev)
    p["attn"] = (attn.mla_init if cfg.mla_kv_lora else attn.gqa_init)(gen, cfg, dtype)
    if moe:
        p["moe"] = moe_init(gen, cfg, dtype)
    else:
        p["ffn"] = ffn_init(gen, d, d_ff, dtype)
    return p


def _norm(cfg, x, w):
    return rms_norm(x, w, plus_one=cfg.post_norms)


def _act(cfg) -> str:
    return "gelu" if cfg.family == "audio" else "silu"


def _ffn_half(p, cfg, x, moe: Optional[MoEFn]):
    """The block's second residual branch: norm, FFN or MoE (``moe(p.moe,
    h)``; the local oracle by default), post-norm."""
    h = _norm(cfg, x, p.norm2)
    if "moe" in p:
        h = moe(p.moe, h) if moe else moe_apply_local(p.moe, cfg, h, chunk=MOE_CHUNK)
    else:
        h = ffn_apply(p.ffn, h, act=_act(cfg))
    if cfg.post_norms:
        h = _norm(cfg, h, p.norm2_post)
    return x + h


def block_prefill(p, cfg: ModelConfig, x: torch.Tensor, *,
                  window: Optional[int] = None, moe: Optional[MoEFn] = None,
                  cs_qkv=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer over the full sequence, and its cache: ``{"k", "v"}`` of
    ``[B, S, Hkv, dh]``, or MLA's ``{"c_kv", "k_rope"}`` (the reference's
    ``LM._prefill_block``).  ``cs_qkv``: the model's activation specs."""
    hn = _norm(cfg, x, p.norm1)
    if cfg.mla_kv_lora:
        h, c_kv, k_rope = attn.mla_attend(p.attn, cfg, hn, cs_qkv)
        cache = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        h, k, v = attn.gqa_attend(p.attn, cfg, hn, window=window, cs_qkv=cs_qkv)
        cache = {"k": k, "v": v}
    if cfg.post_norms:
        h = _norm(cfg, h, p.norm1_post)
    return _ffn_half(p, cfg, x + h, moe), cache


def block_apply(p, cfg: ModelConfig, x: torch.Tensor, *,
                window: Optional[int] = None,
                moe: Optional[MoEFn] = None, cs_qkv=None) -> torch.Tensor:
    """One layer over the full sequence (training)."""
    return block_prefill(p, cfg, x, window=window, moe=moe, cs_qkv=cs_qkv)[0]


def block_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                 length: torch.Tensor, *, pos: int,
                 window: Optional[int] = None,
                 moe: Optional[MoEFn] = None) -> Tuple[torch.Tensor, Dict]:
    h = _norm(cfg, x, p.norm1)
    if cfg.mla_kv_lora:
        h, cache = attn.mla_decode(p.attn, cfg, h, cache, length, pos=pos)
    else:
        h, cache = attn.gqa_decode(p.attn, cfg, h, cache, length, pos=pos,
                                   window=window)
    if cfg.post_norms:
        h = _norm(cfg, h, p.norm1_post)
    return _ffn_half(p, cfg, x + h, moe), cache


def _layer_windows(cfg: ModelConfig, n_layers: int, max_seq: int) -> List[int]:
    """Per-layer attention window (gemma2: even layers local, odd layers
    ``max_seq``, which masks nothing)."""
    if cfg.alt_local_global and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else max_seq
                for i in range(n_layers)]
    return [max_seq] * n_layers


# ---------------------------------------------------------------------------
# the SSM family's layer (rwkv6)
# ---------------------------------------------------------------------------

def _rwkv_layer_init(gen: Optional[torch.Generator], cfg: ModelConfig, dtype) -> Dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=init_device(gen))  # noqa: E731
    return {"block": rwkv.rwkv6_init(gen, cfg, dtype), "norm1": ones(), "norm2": ones()}


def _rwkv_layer(lp, cfg: ModelConfig, x: torch.Tensor, state: Dict
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return rwkv.rwkv6_block_apply(lp.block, cfg, x, state, lp.norm1, lp.norm2)


def _rwkv_apply(lp, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """One rwkv6 layer over the full sequence from a zero state (training)."""
    state = rwkv.rwkv6_init_state(cfg, x.shape[0], x.dtype, x.device)
    return _rwkv_layer(lp, cfg, x, state)[0]


# ---------------------------------------------------------------------------
# LM model object
# ---------------------------------------------------------------------------

class LM(TreeModel, ActShard):
    """Decoder-only LM on one device (CUDA unless ``device="cpu"``).

    ``mesh`` (a ``Topology`` ``(n_pods, n_inner)`` or a ``ProcessMesh``)
    sends the MoE blocks through the expert-parallel island with ``ep``
    (by default the pod axis ``"pod"`` over the inner axis ``"model"``);
    without one they run the dense-masked oracle ``MOE_CHUNK`` tokens at
    a time.  ``mesh`` stays an attribute: setting it moves the same
    weights onto the island or off it.  Set ``moe_stats`` to a list to
    collect each island call's ``stats`` (mode, capacities, dropped
    copies): the forward's calls, never a remat recompute's in the
    backward.  Gradients flow through the island on the f32 wire; a
    narrow wire raises under grad (``moe_apply_sharded``).

    The SSM family (``cfg.family == "ssm"``: rwkv6) has one ``layers``
    entry a block, ``{"block": rwkv6 weights, "norm1", "norm2"}``; its
    cache is each layer's recurrent state.

    ``shard_mesh`` (a production mesh by shape, or None) only names the
    activation specs the model reports while a counter is active
    (:mod:`repro_torch.models.actsharding`); ``mesh`` stays the island's."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None, *,
                 mesh: Any = None, ep: Optional[EPInfo] = None,
                 shard_mesh: Any = None):
        super().__init__(cfg, device)
        self.shard_mesh = shard_mesh
        self.mesh = mesh
        self.ep = ep or (EPInfo(inner_axis="model", pod_axis="pod")
                         if mesh is not None and cfg.is_moe else None)
        self.moe_stats: Optional[List[Dict]] = None
        self.dense_layers = nn.ModuleList()
        self.layers = nn.ModuleList()

    @property
    def n_dense(self) -> int:
        """Leading dense layers of a MoE config (deepseek's first layer)."""
        return self.cfg.first_dense_layers if self.cfg.is_moe else 0

    @property
    def rwkv(self) -> bool:
        return self.cfg.family == "ssm"

    # ---- params -------------------------------------------------------------
    def init_tree(self, gen: Optional[torch.Generator]) -> Dict[str, Any]:
        """A parameter tree drawn from ``gen`` in the reference's order
        (embed, head, dense layers, layers), on the generator's device;
        with no generator, meta tensors of the same shapes and dtypes."""
        cfg = self.cfg
        dtype = dtype_of(cfg)
        tree: Dict[str, Any] = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
            "final_norm": (torch.zeros if cfg.post_norms else torch.ones)(
                (cfg.d_model,), dtype=dtype, device=init_device(gen)),
        }
        if not cfg.tie_embeddings:
            tree["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype)
        if self.rwkv:
            tree["layers"] = [_rwkv_layer_init(gen, cfg, dtype)
                              for _ in range(cfg.n_layers)]
            return tree
        if self.n_dense:
            tree["dense_layers"] = [block_init(gen, cfg, dtype, d_ff=cfg.d_ff)
                                    for _ in range(self.n_dense)]
        tree["layers"] = [block_init(gen, cfg, dtype, moe=cfg.is_moe, d_ff=cfg.d_ff)
                          for _ in range(cfg.n_layers - self.n_dense)]
        return tree

    def head_matrix(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed.T
        return self.head

    # ---- forward ------------------------------------------------------------
    def _moe(self, p, h: torch.Tensor, record: bool = True) -> torch.Tensor:
        """A MoE block's experts: the island over ``mesh`` (its stats into
        ``moe_stats`` when ``record``), or the local oracle."""
        if self.mesh is None:
            return moe_apply_local(p, self.cfg, h, chunk=MOE_CHUNK)
        stats = {} if self.moe_stats is not None and record else None
        out = moe_apply_sharded(p, self.cfg, h, self.ep, self.mesh, stats=stats)
        if stats is not None:
            self.moe_stats.append(stats)
        return out

    def _moe_once(self) -> MoEFn:
        """``_moe`` for one checkpointed layer: its first call (the
        forward) records; the recompute in the backward does not."""
        calls = []

        def moe(p, h):
            calls.append(None)
            return self._moe(p, h, record=len(calls) == 1)

        return moe

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, self.embed)
        if self.cfg.embed_scale:
            # sqrt(d) rounded to the weights' dtype, as the reference does
            x = x * torch.tensor(math.sqrt(self.cfg.d_model)).to(x.dtype).item()
        return x

    def _stack(self, seq: int) -> List[Tuple[nn.Module, Optional[int]]]:
        """Every layer in order with its window for a sequence of ``seq``
        (None: no window): the dense layers, then the stacked ones."""
        cfg = self.cfg
        n = cfg.n_layers - self.n_dense
        windows = (_layer_windows(cfg, n, seq)
                   if cfg.alt_local_global and cfg.sliding_window else [None] * n)
        return [(lp, None) for lp in self.dense_layers] + list(zip(self.layers, windows))

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> hidden [B, S, d] (after the final norm)."""
        cfg = self.cfg
        x = self.cs_hidden(self._embed(tokens))
        remat = cfg.remat and torch.is_grad_enabled()
        if self.rwkv:
            for lp in self.layers:
                self.cs_params(lp)
                x = self.cs_full_hidden(x)
                x = (checkpoint(_rwkv_apply, lp, cfg, x, use_reentrant=False)
                     if remat else _rwkv_apply(lp, cfg, x))
                x = self.cs_hidden(x)
            return _norm(cfg, x, self.final_norm)
        for i, (lp, w) in enumerate(self._stack(tokens.shape[1])):
            stacked = i >= self.n_dense       # the reference's scanned layers
            if stacked:
                self.cs_params(lp)
                x = self.cs_full_hidden(x)
            x = (checkpoint(block_apply, lp, cfg, x, window=w, moe=self._moe_once(),
                            cs_qkv=self.cs_qkv, use_reentrant=False)
                 if remat else block_apply(lp, cfg, x, window=w, moe=self._moe,
                                           cs_qkv=self.cs_qkv))
            if stacked:
                x = self.cs_hidden(x)
        return _norm(cfg, x, self.final_norm)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean token NLL of ``batch["labels"]`` (-1 ignored), float32."""
        h = self.hidden(batch["tokens"])
        return chunked_xent(h, self.head_matrix(), batch["labels"],
                            chunk=self.cfg.xent_chunk,
                            softcap=self.cfg.final_softcap,
                            cs_logits=self.cs_logits)

    def _layer_caches(self, cache: Dict) -> List[Dict[str, torch.Tensor]]:
        """Each layer's view of the stacked cache, in ``_stack``'s order."""
        groups = ([cache["dense_layers"]] if self.n_dense else []) + [cache["layers"]]
        return [{k: v[i] for k, v in g.items()} for g in groups
                for i in range(next(iter(g.values())).shape[0])]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """The prompt in one pass: (logits of the last position [B, V]
        float32, the cache filled to S).  The cache is the reference's,
        ``k`` and ``v`` of ``[L, B, S, Hkv, dh]`` (MLA: ``c_kv`` and
        ``k_rope``), deepseek's dense layers under ``dense_layers``, and
        ``length`` = S, plus the host's ``pos`` = S.  The SSM family's is
        every layer's final state under ``state``, so decoding continues
        from it."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed(tokens)
        caches = []
        if self.rwkv:
            state0 = rwkv.rwkv6_init_state(cfg, b, x.dtype, x.device)
            for lp in self.layers:
                x, c = _rwkv_layer(lp, cfg, x, state0)
                caches.append(c)
        else:
            for i, (lp, w) in enumerate(self._stack(s)):
                stacked = i >= self.n_dense
                if stacked:
                    x = self.cs_full_hidden(x)
                x, c = block_prefill(lp, cfg, x, window=w, moe=self._moe,
                                     cs_qkv=self.cs_qkv)
                if stacked:
                    x = self.cs_hidden(x)
                    for k in sorted(c):
                        self.cs_kv(c[k])
                caches.append(c)
        x = _norm(cfg, x, self.final_norm)
        logits = head_logits(x[:, -1], self.head_matrix(), cfg.final_softcap)
        stacked = lambda cs: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}  # noqa: E731
        cache = {"length": torch.full((b,), s, dtype=torch.int32, device=x.device),
                 "pos": s}
        if self.rwkv:
            cache["state"] = stacked(caches)
            return logits, cache
        cache["layers"] = stacked(caches[self.n_dense:])
        if self.n_dense:
            cache["dense_layers"] = stacked(caches[:self.n_dense])
        return logits, cache

    # ---- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> Dict:
        """Zero caches stacked over layers, ``[L, B, S, Hkv, D]`` each (MLA:
        ``c_kv [L, B, S, r_kv]`` and ``k_rope [L, B, S, rope]``; the dense
        layers' under ``dense_layers``), the per-sequence ``length`` on the
        device and its host copy ``pos``.  The SSM family's is the zero
        state of every layer under ``state`` (``S [L, B, H, N, N]`` float32,
        ``last_x`` and ``last_x_c`` ``[L, B, d]``): O(1) in ``max_seq``."""
        cfg = self.cfg
        if self.rwkv:
            one = rwkv.rwkv6_init_state(cfg, batch, dtype_of(cfg), self.device)
        else:
            mk = attn.mla_init_cache if cfg.mla_kv_lora else attn.gqa_init_cache
            one = mk(cfg, batch, max_seq, dtype_of(cfg), self.device)

        def stacked(n):
            return {k: torch.zeros((n,) + v.shape, dtype=v.dtype, device=v.device)
                    for k, v in one.items()}

        cache = {"length": torch.zeros((batch,), dtype=torch.int32, device=self.device),
                 "pos": 0}
        if self.rwkv:
            cache["state"] = stacked(cfg.n_layers)
            return cache
        cache["layers"] = stacked(cfg.n_layers - self.n_dense)
        if self.n_dense:
            cache["dense_layers"] = stacked(self.n_dense)
        return cache

    @torch.no_grad()
    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B, 1] -> (logits [B, 1, V] float32, cache).

        The cache is updated in place (see ``attention.gqa_decode`` and
        ``mla_decode``; the SSM family's states by copy) and returned;
        ``length`` and ``pos`` advance by one.
        """
        cfg = self.cfg
        length, pos = cache["length"], cache["pos"]
        x = self._embed(tokens)
        if self.rwkv:
            states = cache["state"]
            for i, lp in enumerate(self.layers):
                x, st = _rwkv_layer(lp, cfg, x, {k: v[i] for k, v in states.items()})
                for k, v in st.items():
                    states[k][i] = v
        else:
            max_seq = next(iter(cache["layers"].values())).shape[2]
            for i, ((lp, w), c) in enumerate(zip(self._stack(max_seq),
                                                 self._layer_caches(cache))):
                x, _ = block_decode(lp, cfg, x, c, length, pos=pos, window=w,
                                    moe=self._moe)
                if i >= self.n_dense:
                    x = self.cs_hidden(x)
        cache["length"] = length + 1
        cache["pos"] = pos + 1
        x = _norm(cfg, x, self.final_norm)
        return head_logits(x, self.head_matrix(), cfg.final_softcap), cache

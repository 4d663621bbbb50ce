"""Decoder-only LM: the dense GQA family and the MoE family (qwen3-moe's
GQA + MoE blocks; deepseek-v2's MLA attention, shared experts and dense
first layer): training, prefill and decoding.

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
                                        "length", "pos"}
    decode_step(cache, tokens [B,1]) -> (logits [B, 1, V] float32, cache)

MoE blocks run ``moe_apply_local`` (the dense-masked oracle, in chunks of
``MOE_CHUNK`` tokens) without a mesh, and the expert-parallel island
``moe_apply_sharded`` with ``mesh=`` a ``Topology`` or a
``ProcessMesh``, as the reference's ``LM(mesh=, ep=)``.  The SSM, hybrid
and encoder-decoder families wait for their slices (ROADMAP Queue 1
items 7e-7g).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

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
from repro_torch.models.moe import (EPInfo, moe_apply_local,
                                    moe_apply_sharded, moe_init)

# tokens of the dense-masked MoE oracle computed at once: every expert on
# every token, [chunk, E, moe_dff] and [chunk, E, d] intermediates
MOE_CHUNK = 256

MoEFn = Callable[[Any, torch.Tensor], torch.Tensor]


def unported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet, or None for the dense and
    MoE families."""
    if cfg.is_encoder_decoder:
        return "the encoder-decoder family (ROADMAP Queue 1 item 7e)"
    if cfg.family == "hybrid":
        return "the hybrid SSM family (ROADMAP Queue 1 item 7f)"
    if cfg.family == "ssm":
        return "the RWKV SSM family (ROADMAP Queue 1 item 7g)"
    return None


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
                  window: Optional[int] = None, moe: Optional[MoEFn] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer over the full sequence, and its cache: ``{"k", "v"}`` of
    ``[B, S, Hkv, dh]``, or MLA's ``{"c_kv", "k_rope"}`` (the reference's
    ``LM._prefill_block``)."""
    hn = _norm(cfg, x, p.norm1)
    if cfg.mla_kv_lora:
        h, c_kv, k_rope = attn.mla_attend(p.attn, cfg, hn)
        cache = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        h, k, v = attn.gqa_attend(p.attn, cfg, hn, window=window)
        cache = {"k": k, "v": v}
    if cfg.post_norms:
        h = _norm(cfg, h, p.norm1_post)
    return _ffn_half(p, cfg, x + h, moe), cache


def block_apply(p, cfg: ModelConfig, x: torch.Tensor, *,
                window: Optional[int] = None,
                moe: Optional[MoEFn] = None) -> torch.Tensor:
    """One layer over the full sequence (training)."""
    return block_prefill(p, cfg, x, window=window, moe=moe)[0]


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


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: leaves are ``nn.Parameter``s,
    dicts are sub-trees, read as ``p["wq"]`` or ``p.attn``; ``tree()``
    gives the dict back (of the parameters themselves).  A layer is one:
    ``norm*`` tensors and the ``attn`` and ``ffn`` or ``moe`` sub-trees
    keyed as in the reference (``p.attn["wq"]``, ``p.moe["shared"]["w_up"]``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, t in tree.items():
            if isinstance(t, dict):
                self.add_module(name, ParamTree(t))
            else:
                self.register_parameter(name, nn.Parameter(t))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self._parameters)
        out.update((name, m.tree()) for name, m in self._modules.items())
        return out


# ---------------------------------------------------------------------------
# LM model object
# ---------------------------------------------------------------------------

class LM(nn.Module):
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
    narrow wire raises under grad (``moe_apply_sharded``)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None, *,
                 mesh: Any = None, ep: Optional[EPInfo] = None):
        super().__init__()
        reason = unported_reason(cfg)
        if reason:
            raise NotImplementedError(f"{cfg.name}: not ported yet; it needs {reason}")
        self.cfg = cfg
        self.device = resolve_device(device)
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
        if self.n_dense:
            tree["dense_layers"] = [block_init(gen, cfg, dtype, d_ff=cfg.d_ff)
                                    for _ in range(self.n_dense)]
        tree["layers"] = [block_init(gen, cfg, dtype, moe=cfg.is_moe, d_ff=cfg.d_ff)
                          for _ in range(cfg.n_layers - self.n_dense)]
        return tree

    def init(self, seed: Union[int, torch.Generator] = 0) -> "LM":
        """Random weights drawn on the model's device; a Generator or a
        seed for one."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(seed)
        return self._set(self.init_tree(gen), copy=False)

    def load(self, tree: Dict[str, Any]) -> "LM":
        """Take a parameter tree ({"embed", "final_norm", ["head"],
        ["dense_layers"], "layers": [block trees]}), copied to the model's
        device and dtype (the MoE router stays float32, as drawn; training
        updates the weights in place; the caller's tree stays as it was)."""
        return self._set(tree, copy=True)

    def _set(self, tree: Dict[str, Any], copy: bool) -> "LM":
        dtype = dtype_of(self.cfg)

        def move(t, name=""):
            if isinstance(t, dict):
                return {k: move(v, k) for k, v in t.items()}
            return t.to(device=self.device, copy=copy,
                        dtype=torch.float32 if name == "router" else dtype)

        for group, n in (("dense_layers", self.n_dense),
                         ("layers", self.cfg.n_layers - self.n_dense)):
            got = len(tree.get(group, []))
            if got != n:
                raise ValueError(f"{got} {group} for a config of {n}")
        for name in ("embed", "final_norm", "head"):
            if name in tree:
                self.register_parameter(name, nn.Parameter(move(tree[name])))
        self.dense_layers = nn.ModuleList(ParamTree(move(lp))
                                          for lp in tree.get("dense_layers", []))
        self.layers = nn.ModuleList(ParamTree(move(lp)) for lp in tree["layers"])
        return self

    def param_tree(self) -> Dict[str, Any]:
        """The weights (``nn.Parameter``s, trainable) as the reference's
        tree with the layers as a list: what ``optim.adamw`` and the
        checkpoints walk."""
        tree: Dict[str, Any] = {name: getattr(self, name) for name in
                                ("embed", "final_norm", "head") if hasattr(self, name)}
        if self.n_dense:
            tree["dense_layers"] = [lp.tree() for lp in self.dense_layers]
        tree["layers"] = [lp.tree() for lp in self.layers]
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
        x = self._embed(tokens)
        remat = cfg.remat and torch.is_grad_enabled()
        for lp, w in self._stack(tokens.shape[1]):
            x = (checkpoint(block_apply, lp, cfg, x, window=w, moe=self._moe_once(),
                            use_reentrant=False)
                 if remat else block_apply(lp, cfg, x, window=w, moe=self._moe))
        return _norm(cfg, x, self.final_norm)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean token NLL of ``batch["labels"]`` (-1 ignored), float32."""
        h = self.hidden(batch["tokens"])
        return chunked_xent(h, self.head_matrix(), batch["labels"],
                            chunk=self.cfg.xent_chunk,
                            softcap=self.cfg.final_softcap)

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
        ``length`` = S, plus the host's ``pos`` = S."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed(tokens)
        caches = []
        for lp, w in self._stack(s):
            x, c = block_prefill(lp, cfg, x, window=w, moe=self._moe)
            caches.append(c)
        x = _norm(cfg, x, self.final_norm)
        logits = head_logits(x[:, -1], self.head_matrix(), cfg.final_softcap)
        stacked = lambda cs: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}  # noqa: E731
        cache = {"layers": stacked(caches[self.n_dense:]),
                 "length": torch.full((b,), s, dtype=torch.int32, device=x.device),
                 "pos": s}
        if self.n_dense:
            cache["dense_layers"] = stacked(caches[:self.n_dense])
        return logits, cache

    # ---- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> Dict:
        """Zero caches stacked over layers, ``[L, B, S, Hkv, D]`` each (MLA:
        ``c_kv [L, B, S, r_kv]`` and ``k_rope [L, B, S, rope]``; the dense
        layers' under ``dense_layers``), the per-sequence ``length`` on the
        device and its host copy ``pos``."""
        cfg = self.cfg
        mk = attn.mla_init_cache if cfg.mla_kv_lora else attn.gqa_init_cache
        one = mk(cfg, batch, max_seq, dtype_of(cfg), self.device)

        def stacked(n):
            return {k: torch.zeros((n,) + v.shape, dtype=v.dtype, device=v.device)
                    for k, v in one.items()}

        cache = {"layers": stacked(cfg.n_layers - self.n_dense),
                 "length": torch.zeros((batch,), dtype=torch.int32, device=self.device),
                 "pos": 0}
        if self.n_dense:
            cache["dense_layers"] = stacked(self.n_dense)
        return cache

    @torch.no_grad()
    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B, 1] -> (logits [B, 1, V] float32, cache).

        The cache is updated in place (see ``attention.gqa_decode`` and
        ``mla_decode``) and returned; ``length`` and ``pos`` advance by one.
        """
        cfg = self.cfg
        length, pos = cache["length"], cache["pos"]
        x = self._embed(tokens)
        max_seq = next(iter(cache["layers"].values())).shape[2]
        for (lp, w), c in zip(self._stack(max_seq), self._layer_caches(cache)):
            x, _ = block_decode(lp, cfg, x, c, length, pos=pos, window=w,
                                moe=self._moe)
        cache["length"] = length + 1
        cache["pos"] = pos + 1
        x = _norm(cfg, x, self.final_norm)
        return head_logits(x, self.head_matrix(), cfg.final_softcap), cache

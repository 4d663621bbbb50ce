"""RWKV6 (Finch) block: attention-free time mixing with data-dependent
decay, mirroring ``repro/models/rwkv.py``.

Per head of size N: a state S in R^{N x N} evolves as
    y_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with the data-dependent per-channel decay w_t = exp(-exp(w0 + LoRA(x_t))).
Token shift is the learned mix of x_t and x_{t-1}.

``rwkv6_time_mix`` runs the recurrence a step at a time (a Python loop
where the reference scans); ``rwkv6_time_mix_chunked`` is the chunked
(GLA) form the reference holds against it.  ``rwkv6_block_apply`` takes
the chunked form only when ``cfg.rwkv_chunk`` divides S and S > 1.
The recurrence runs in float32; ``w0`` and ``u`` are float32 in a bf16
model, as the reference draws them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, init_device, rms_norm

LORA_R = 32


def rwkv6_init(gen: Optional[torch.Generator], cfg, dtype) -> Dict[str, torch.Tensor]:
    """The block's weights, drawn from ``gen`` (meta tensors without one)."""
    d, dev = cfg.d_model, init_device(gen)
    full = lambda v, dt=dtype: torch.full((d,), v, dtype=dt, device=dev)  # noqa: E731

    def normal(shape, std, dt):
        if gen is None:
            return torch.empty(shape, dtype=dt, device="meta")
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
                * std).to(dt)

    return {
        # time mix
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_w": full(0.5), "mix_g": full(0.5),
        "wr": dense_init(gen, d, d, dtype), "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype), "wg": dense_init(gen, d, d, dtype),
        "wo": dense_init(gen, d, d, dtype),
        "w0": full(-2.0, torch.float32),                 # base decay
        "w_lora_a": dense_init(gen, d, LORA_R, dtype),
        "w_lora_b": normal((LORA_R, d), 0.01, dtype),
        "u": normal((d,), 0.1, torch.float32),
        "ln_x": full(1.0),
        # channel mix
        "cmix_k": full(0.5), "cmix_r": full(0.5),
        "ck": dense_init(gen, d, cfg.d_ff, dtype),
        "cv": dense_init(gen, cfg.d_ff, d, dtype),
        "cr": dense_init(gen, d, d, dtype),
    }


def _shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x_{t-1} with ``last`` as the t = -1 element.  x: [B, S, d], last [B, d]."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _time_mix_rates(p, x: torch.Tensor, last_x: torch.Tensor):
    """r, k, v, the gate g (x's dtype) and the decay's rate
    e = exp(w0 + LoRA(x)) (float32, > 0), each [B, S, d].  The decay is
    w = exp(-e) and its log is -e, taken whole: exp(-e) is 0 in float32
    once e passes ~104, and the log of that 0 is -inf."""
    xs = _shift(x, last_x)
    mix = lambda m: x * m + xs * (1.0 - m)  # noqa: E731
    r = mix(p["mix_r"]) @ p["wr"]
    k = mix(p["mix_k"]) @ p["wk"]
    v = mix(p["mix_v"]) @ p["wv"]
    g = F.silu(mix(p["mix_g"]) @ p["wg"])
    xw = mix(p["mix_w"])
    lora = (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    return r, k, v, g, torch.exp(p["w0"] + lora)


def _time_mix_inputs(p, cfg, x: torch.Tensor, last_x: torch.Tensor):
    """r, k, v, the gate g (x's dtype) and the decay w (float32, in [0, 1)),
    each [B, S, d]."""
    r, k, v, g, rate = _time_mix_rates(p, x, last_x)
    return r, k, v, g, torch.exp(-rate)


def _wkv(r, k, v, w, u, state, head_size: int):
    """One step.  r, k, v, w: [B, d]; state: [B, H, N, N] float32 ->
    (y [B, d] float32, state)."""
    b, d = r.shape
    h, n = d // head_size, head_size
    rh = r.reshape(b, h, n).float()
    kh = k.reshape(b, h, n).float()
    vh = v.reshape(b, h, n).float()
    wh = w.reshape(b, h, n)
    uh = u.reshape(h, n)
    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    y = torch.einsum("bhk,bhkv->bhv", rh, uh[None, :, :, None] * kv + state)
    state = wh[..., None] * state + kv
    return y.reshape(b, d), state


def rwkv6_time_mix(p, cfg, x: torch.Tensor, state: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence time mixing, one step of the recurrence at a time.
    x: [B, S, d]; state {"S" [B, H, N, N] float32, "last_x" [B, d]}."""
    r, k, v, g, w = _time_mix_inputs(p, cfg, x, state["last_x"])
    s, ys = state["S"], []
    for t in range(x.shape[1]):
        y, s = _wkv(r[:, t], k[:, t], v[:, t], w[:, t], p["u"], s, cfg.rwkv_head_size)
        ys.append(y)
    y = torch.stack(ys, dim=1).to(x.dtype)
    y = rms_norm(y, p["ln_x"]) * g
    return y @ p["wo"], {"S": s, "last_x": x[:, -1]}


def rwkv6_time_mix_chunked(p, cfg, x: torch.Tensor, state: Dict[str, torch.Tensor],
                           chunk: int = 16
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked (GLA-style) time mixing: within a chunk of L steps the
    recurrence is a decay-masked (L x L) product, and only the chunk-to-
    chunk state is carried (S / L steps).  Every decay ratio is exp of the
    sum of the log decays it spans (at most 0), never of a difference of
    two running sums: under a steep decay those reach hundreds, exp of
    their difference overflows above the diagonal (an inf whose gradient
    is NaN even where ``torch.where`` drops it) and the gradient of the
    difference cancels to a few percent of its size.  The log decays are
    -exp(w0 + LoRA) themselves, never the log of the decay w, which is 0
    in float32 once exp(w0 + LoRA) passes ~104 (the log's -inf made the
    backward multiply inf by 0).  The one edge left: -exp(z) is -inf for
    z > ~88.7, far beyond any decay a model draws (``rwkv6_init``'s w0 is
    -2).  Equal to ``rwkv6_time_mix`` up to float round-off, its gradient
    too."""
    b, s, d = x.shape
    n = cfg.rwkv_head_size
    h = d // n
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {L}")
    nc = s // L
    r, k, v, g, rate = _time_mix_rates(p, x, state["last_x"])
    rh = r.reshape(b, nc, L, h, n).float()
    kh = k.reshape(b, nc, L, h, n).float()
    vh = v.reshape(b, nc, L, h, n).float()
    lw = -rate.reshape(b, nc, L, h, n)                  # log w: negative, finite
    lcum = torch.cumsum(lw, dim=2)                      # [B, nc, L, H, N]
    lprev = torch.cat([torch.zeros_like(lcum[:, :, :1]), lcum[:, :, :-1]], dim=2)
    uh = p["u"].reshape(h, n)

    # intra-chunk: a[t, j] = sum_n r_t exp(span_tj) k_j   (j < t), with
    # span_tj = sum_{j < i < t} lw_i: lw_i kept where i > j, summed over
    # i <= t - 1; 0 (a ratio of 1, dropped below) where j >= t
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device), diagonal=-1)
    span = torch.cumsum(torch.where(tri[:, :, None, None], lw[:, :, :, None], 0.0), dim=2)
    span = torch.cat([torch.zeros_like(span[:, :, :1]), span[:, :, :-1]], dim=2)
    ratio = torch.exp(span)                             # [B,nc,L,L,H,N]
    a = torch.einsum("bcthn,bcjhn,bctjhn->bchtj", rh, kh, ratio)
    a = torch.where(tri, a, 0.0)
    y = torch.einsum("bchtj,bcjhn->bcthn", a, vh)
    # diagonal bonus term: r_t . (u o k_t) v_t
    diag = torch.einsum("bcthn,bcthn->bcth", rh, uh * kh)
    y = y + diag[..., None] * vh

    # inter-chunk: y_t += (r_t o exp(lprev_t)) S_prev, chunk by chunk
    # decay k_j to the chunk's end: exp(sum_{i > j} lw_i)
    after = torch.flip(torch.cumsum(torch.flip(lw, [2]), dim=2), [2])
    after = torch.cat([after[:, :, 1:], torch.zeros_like(after[:, :, :1])], dim=2)
    k_tail = kh * torch.exp(after)
    r_dec = rh * torch.exp(lprev)
    dec_all = torch.exp(lcum[:, :, -1])                 # [B, nc, H, N]
    s_run, y_inter = state["S"], []
    for c in range(nc):
        y_inter.append(torch.einsum("bthn,bhnv->bthv", r_dec[:, c], s_run))
        s_run = s_run * dec_all[:, c, ..., None] + torch.einsum(
            "bthn,bthv->bhnv", k_tail[:, c], vh[:, c])
    y = y + torch.stack(y_inter, dim=1)
    y = y.reshape(b, s, d).to(x.dtype)
    y = rms_norm(y, p["ln_x"]) * g
    return y @ p["wo"], {"S": s_run, "last_x": x[:, -1]}


def rwkv6_channel_mix(p, cfg, x: torch.Tensor, state: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    xs = _shift(x, state["last_x_c"])
    xk = x * p["cmix_k"] + xs * (1.0 - p["cmix_k"])
    xr = x * p["cmix_r"] + xs * (1.0 - p["cmix_r"])
    k = torch.square(torch.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]) * (k @ p["cv"]), {"last_x_c": x[:, -1]}


def rwkv6_init_state(cfg, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    d, n = cfg.d_model, cfg.rwkv_head_size
    h = d // n
    return {"S": torch.zeros((batch, h, n, n), dtype=torch.float32, device=device),
            "last_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "last_x_c": torch.zeros((batch, d), dtype=dtype, device=device)}


def rwkv6_block_apply(p, cfg, x: torch.Tensor, state: Dict[str, torch.Tensor],
                      norm1: torch.Tensor, norm2: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pre-norm residual block: time mix then channel mix.  Returns the
    block's output and its final state (``S``, ``last_x``, ``last_x_c``)."""
    chunk = getattr(cfg, "rwkv_chunk", 0)
    tm_state = {k: state[k] for k in ("S", "last_x")}
    if chunk and x.shape[1] % chunk == 0 and x.shape[1] > 1:
        y, st_t = rwkv6_time_mix_chunked(p, cfg, rms_norm(x, norm1), tm_state,
                                         chunk=chunk)
    else:
        y, st_t = rwkv6_time_mix(p, cfg, rms_norm(x, norm1), tm_state)
    x = x + y
    y, st_c = rwkv6_channel_mix(p, cfg, rms_norm(x, norm2),
                                {"last_x_c": state["last_x_c"]})
    return x + y, {**st_t, **st_c}

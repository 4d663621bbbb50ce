"""Mamba2 (SSD) block, mirroring ``repro/models/ssm.py``: the chunked
matmul form over a sequence, the one-token step against a carried state,
and the sequential oracle.

Within a chunk of length L the recurrence is an (L x L) decay-masked
product; only the chunk-to-chunk state is carried (S / L steps of a
Python loop where the reference scans).  Recurrence (one scalar A a
head):
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * x_t B_t^T        h: [P, N]
    y_t = h_t C_t + D_h x_t
``dt_bias``, ``a_log`` and ``d_skip`` are float32 in a bf16 model, as the
reference draws them; the state runs in float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, init_device


def mamba2_init(gen: Optional[torch.Generator], cfg, dtype) -> Dict[str, torch.Tensor]:
    """The block's weights, drawn from ``gen`` (meta tensors without one)."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    h = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    dev = init_device(gen)
    f32 = dict(dtype=torch.float32, device=dev)
    if gen is None:
        conv_w = torch.empty((cfg.ssm_conv, d_in), dtype=dtype, device=dev)
    else:
        conv_w = (torch.randn((cfg.ssm_conv, d_in), generator=gen, device=dev,
                              dtype=torch.float32) * 0.1).to(dtype)
    return {
        "in_proj": dense_init(gen, d, 2 * d_in, dtype),      # x, z (gate)
        "bc_proj": dense_init(gen, d, 2 * n, dtype),         # B, C (1 group)
        "dt_proj": dense_init(gen, d, h, dtype),
        "dt_bias": torch.zeros((h,), **f32),
        "a_log": torch.zeros((h,), **f32),                   # A = -exp(a_log)
        "d_skip": torch.ones((h,), **f32),
        "conv_w": conv_w,
        "out_proj": dense_init(gen, d_in, d, dtype),
    }


def _project(p, cfg, x: torch.Tensor, conv_state: Optional[torch.Tensor] = None):
    """The shared projections.  x: [B, S, d] -> (u, z, B, C, dt, new_conv):
    u the causal depthwise conv of the x half through SiLU, z the gate,
    B and C [B, S, N], dt [B, S, H] float32, and the conv's tail
    [B, conv - 1, d_in] for the next call.  ``conv_state`` is the tail of
    the previous tokens (decode); None starts from zeros."""
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    xz = x @ p["in_proj"]
    xs, z = xz[..., :d_in], xz[..., d_in:]
    K = cfg.ssm_conv
    if conv_state is None:
        pad = torch.zeros((b, K - 1, d_in), dtype=xs.dtype, device=x.device)
    else:
        pad = conv_state.to(xs.dtype)
    xpad = torch.cat([pad, xs], dim=1)
    new_conv = xpad[:, -(K - 1):] if K > 1 else xpad[:, :0]
    conv = sum(xpad[:, i:i + s] * p["conv_w"][i][None, None] for i in range(K))
    u = F.silu(conv)
    bc = x @ p["bc_proj"]
    n = cfg.ssm_state
    b_mat, c_mat = bc[..., :n], bc[..., n:]
    dt = F.softplus((x @ p["dt_proj"]).float() + p["dt_bias"])   # [B, S, H]
    return u, z, b_mat, c_mat, dt, new_conv


def mamba2_apply(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Chunked SSD over a full sequence from a zero state.  x: [B, S, d]
    -> [B, S, d]."""
    b, s, d = x.shape
    P, n = cfg.ssm_head_dim, cfg.ssm_state
    L = min(cfg.ssm_chunk, s)
    if s % L:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {L}")
    nc = s // L
    u, z, bm, cm, dt, _ = _project(p, cfg, x)
    d_in = u.shape[-1]
    h = d_in // P
    uh = u.reshape(b, nc, L, h, P)
    dtc = dt.reshape(b, nc, L, h)
    bc = bm.reshape(b, nc, L, n).float()
    cc = cm.reshape(b, nc, L, n).float()
    a = -torch.exp(p["a_log"])                                # [H]
    la = dtc * a                                              # log decay a step
    lcum = torch.cumsum(la, dim=2)                            # [B, nc, L, H]

    # ---- intra-chunk: decay-masked (L x L) product ------------------------
    # M[i, j] = (C_i . B_j) * exp(lcum_i - lcum_j) * dt_j   for j <= i.  Above
    # the diagonal the exponent is positive and exp would overflow to inf:
    # torch.where drops it from the values, but the gradient of the
    # product through it is 0 x inf = NaN, so the exponent is set to 0
    # there before exp (the values are the same)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)              # [B, nc, L, L]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    seg = torch.where(tri[:, :, None], lcum[:, :, :, None] - lcum[:, :, None], 0.0)
    ratio = torch.exp(seg)                                    # [B,nc,L,L,H]
    m = torch.where(tri[:, :, None], cb[..., None] * ratio, 0.0)
    m = m * dtc[:, :, None, :, :]                             # dt_j on the source
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m.to(uh.dtype), uh)

    # ---- chunk states, carried chunk to chunk -------------------------------
    # chunk c's share of the state: sum_j exp(lcum_L - lcum_j) dt_j u_j B_j^T
    tail = torch.exp(lcum[:, :, -1:, :] - lcum)               # [B, nc, L, H]
    su = (uh * (tail * dtc)[..., None]).float()
    s_chunk = torch.einsum("bclhp,bcln->bchpn", su, bc)       # [B, nc, H, P, N]
    decay_chunk = torch.exp(lcum[:, :, -1])                   # [B, nc, H]
    hs = [torch.zeros((b, h, P, n), dtype=torch.float32, device=x.device)]
    for c in range(nc - 1):                                   # the state before c
        hs.append(hs[-1] * decay_chunk[:, c, :, None, None] + s_chunk[:, c])
    h_prevs = torch.stack(hs, dim=1)                          # [B, nc, H, P, N]

    # y_inter_i = C_i . (exp(lcum_i) * h_prev)
    dec_i = torch.exp(lcum)                                   # [B, nc, L, H]
    y_inter = torch.einsum("bcin,bchpn->bcihp", cc, h_prevs) * dec_i[..., None]
    y = y_intra.float() + y_inter                             # [B, nc, L, H, P]
    y = y + uh.float() * p["d_skip"][:, None]
    y = y.reshape(b, s, d_in).to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"]


def mamba2_init_state(cfg, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    return {
        "h": torch.zeros((batch, h, cfg.ssm_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype, device=device),
    }


def mamba2_decode(p, cfg, x: torch.Tensor, state: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step.  x: [B, 1, d]; state {"h" [B, H, P, N] float32,
    "conv" [B, conv - 1, d_in]} -> (y [B, 1, d], the new state)."""
    b = x.shape[0]
    P = cfg.ssm_head_dim
    u, z, bm, cm, dt, new_conv = _project(p, cfg, x, state["conv"])
    d_in = u.shape[-1]
    h = d_in // P
    uh = u.reshape(b, h, P).float()
    a = -torch.exp(p["a_log"])
    dec = torch.exp(dt[:, 0] * a[None])                       # [B, H]
    hs = state["h"] * dec[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", uh * dt[:, 0][..., None], bm[:, 0].float())
    y = torch.einsum("bhpn,bn->bhp", hs, cm[:, 0].float())
    y = y + uh * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, d_in).to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"h": hs, "conv": new_conv}


def mamba2_scan_ref(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Step-by-step recurrence (slow, exact): the test oracle."""
    state = mamba2_init_state(cfg, x.shape[0], x.dtype, x.device)
    outs = []
    for t in range(x.shape[1]):
        y, state = mamba2_decode(p, cfg, x[:, t:t + 1], state)
        outs.append(y)
    return torch.cat(outs, dim=1)

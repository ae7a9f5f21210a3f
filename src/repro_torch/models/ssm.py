"""Mamba2 block (SSD): chunked scan over a sequence, O(1)-state decode.

Counterpart of ``repro/models/ssm.py``.  A single input projection yields
(z, x, B, C, dt); x/B/C pass through a short causal depthwise conv; the
SSD scan mixes sequence information (``ops.ssd_scan``, K4 on the card);
a gated RMSNorm and the output projection close the block.  Decode
carries (conv_state, ssd_state), kept in the model dtype and rounded to
it every step, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from .config import ArchConfig
from .layers import dense_init, param, rms_norm


class SSMState(NamedTuple):
    conv: torch.Tensor       # (B, conv_w - 1, d_conv_in)
    ssd: torch.Tensor        # (B, H, P, N)


class SSM(nn.Module):
    """ssm_in (d, 2*di + 2*N + H) for (z, x, B, C, dt); conv_w (K, di + 2*N);
    A_log, D, dt_bias (H,) f32; gnorm (di,); ssm_out (di, d)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        f32 = torch.float32
        self.ssm_in = param((d, 2 * di + 2 * N + H), dtype, device)
        self.conv_w = param((cfg.ssm_conv, di + 2 * N), dtype, device)
        self.A_log = param((H,), f32, device)
        self.D = param((H,), f32, device)
        self.dt_bias = param((H,), f32, device)
        self.gnorm = param((di,), dtype, device)
        self.ssm_out = param((di, d), dtype, device)


@torch.no_grad()
def init_ssm(gen: torch.Generator, p: SSM) -> SSM:
    """Fill `p` as ``repro/models/ssm.py:init_ssm`` does (other numbers)."""
    dense_init(gen, p.ssm_in)
    dense_init(gen, p.conv_w, scale=0.5)
    p.A_log.zero_()
    p.D.fill_(1.0)
    p.dt_bias.zero_()
    p.gnorm.zero_()
    dense_init(gen, p.ssm_out)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x (B, S, C); w (K, C).  Returns (silu(y),
    the last K-1 inputs as the new state)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, xp.shape[1] - (K - 1):]
    return F.silu(y), new_state


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * N],
            proj[..., 2 * di + 2 * N:])


def ssm_block(p: SSM, h: torch.Tensor, cfg: ArchConfig,
              state: Optional[SSMState] = None
              ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """h (B, S, d) full-sequence (state=None) or (B, 1, d) decode."""
    B, S, _ = h.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    proj = h @ p.ssm_in
    z, xBC, dt_raw = _split_proj(cfg, proj)
    dt = F.softplus(dt_raw.float() + p.dt_bias)             # (B, S, H)
    A = -torch.exp(p.A_log)                                 # (H,)

    if state is None:
        xBC, _ = _causal_conv(xBC, p.conv_w)
        xs = xBC[..., :di].reshape(B, S, H, P)
        Bm = xBC[..., di:di + N]
        Cm = xBC[..., di + N:]
        y, _ = ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        y = (y + xs * p.D[None, None, :, None]).to(h.dtype)
        y = y.reshape(B, S, di)
        y = rms_norm(p.gnorm, y * F.silu(z), cfg.norm_eps)
        return (y @ p.ssm_out).to(h.dtype), None

    # ---- decode step ----
    xBC_t, conv_state = _causal_conv(xBC, p.conv_w, state.conv)
    xs = xBC_t[:, 0, :di].reshape(B, H, P)
    Bm = xBC_t[:, 0, di:di + N]
    Cm = xBC_t[:, 0, di + N:]
    y, ssd_state = ops.ssd_step(state.ssd, xs, dt[:, 0], A, Bm, Cm)
    y = (y + xs * p.D[None, :, None]).to(h.dtype)
    y = y.reshape(B, 1, di)
    y = rms_norm(p.gnorm, y * F.silu(z), cfg.norm_eps)
    return (y @ p.ssm_out).to(h.dtype), \
        SSMState(conv_state.to(state.conv.dtype),
                 ssd_state.to(state.ssd.dtype))


def init_ssm_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   device, lead: Tuple[int, ...] = ()) -> SSMState:
    """Zero decode state; `lead` prepends axes (layers, groups)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    kw = dict(dtype=dtype, device=device)
    return SSMState(
        conv=torch.zeros(lead + (batch, cfg.ssm_conv - 1, di + 2 * N), **kw),
        ssd=torch.zeros(lead + (batch, H, P, N), **kw))

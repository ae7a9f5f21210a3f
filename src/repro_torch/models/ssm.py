"""Mamba2 block (SSD): chunked scan over a sequence, O(1)-state decode.

Counterpart of ``repro/models/ssm.py``.  A single input projection yields
(z, x, B, C, dt); x/B/C pass through a short causal depthwise conv; the
SSD scan mixes sequence information (``ops.ssd_scan``, K4 on the card);
a gated RMSNorm and the output projection close the block.  Decode
carries (conv_state, ssd_state), kept in the model dtype and rounded to
it every step, as in the JAX package.

Under a `model` mesh axis of n > 1 (``models.sharding``) the block runs
on this rank's H / n heads (``_ssm_block_tp``): the projection from this
rank's columns of ssm_in, gathered over the axis (each rank then slices
its heads' z, x and dt and the shared B and C), the conv on those
channels, K4 (or the decode step) on the local heads, the gated norm
with its sum of squares added over the ranks, this rank's rows of
ssm_out and one sum over the axis.  The decode state holds the local
heads and this rank's contiguous part of the conv channels, as
``registry.cache_specs`` lays them out.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from . import sharding
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
    if sharding.model_parallel():
        return _ssm_block_tp(p, h, cfg, state)
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


def _ssm_block_tp(p: SSM, h: torch.Tensor, cfg: ArchConfig,
                  state: Optional[SSMState]
                  ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """``ssm_block`` on this rank's H / n heads (the depth format; module
    doc).  h (B, S, d) replicated over `model` -> (B, S, d) replicated;
    `state` holds this rank's heads of the SSD state and its part of the
    conv channels (all of them where the axis does not divide them)."""
    B, S, _ = h.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    n, r = sharding.mesh_axis_size("model"), sharding.axis_rank("model")
    if H % n:
        raise ValueError(f"{cfg.name}: {H} SSD heads do not split over a "
                         f"model axis of {n}")
    Hl, dl = H // n, di // n
    # the whole projection on every rank, from this rank's columns
    if sharding.shard_dim(p.ssm_in) is not None:
        proj = sharding.gather_rows(sharding.copy_to(h) @ p.ssm_in, -1,
                                    "model")
    else:
        proj = sharding.copy_to(h @ p.ssm_in)
    heads = slice(r * dl, (r + 1) * dl)
    z = proj[..., heads]
    xBC_all = proj[..., di:2 * di + 2 * N]
    xBC = torch.cat([xBC_all[..., heads], xBC_all[..., di:]], dim=-1)
    dt_raw = proj[..., 2 * di + 2 * N + r * Hl:2 * di + 2 * N + (r + 1) * Hl]
    conv_w = sharding.full_for_rank_work(p.conv_w)       # (K, di + 2N)
    conv_w = torch.cat([conv_w[:, heads], conv_w[:, di:]], dim=1)
    dt = F.softplus(dt_raw.float() + sharding.local(p.dt_bias, 0))
    A = -torch.exp(sharding.local(p.A_log, 0))
    D = sharding.local(p.D, 0)

    if state is None:
        xBC, _ = _causal_conv(xBC, conv_w)
        xs = xBC[..., :dl].reshape(B, S, Hl, P)
        y, _ = ops.ssd_scan(xs, dt, A, xBC[..., dl:dl + N],
                            xBC[..., dl + N:], chunk=cfg.ssm_chunk)
        y = (y + xs * D[None, None, :, None]).to(h.dtype)
        y = _gated_norm_tp(p, y.reshape(B, S, dl), z, cfg, heads)
        return sharding.reduce_from(y @ sharding.local(p.ssm_out, 0)
                                    ).to(h.dtype), None

    # ---- decode step: the conv state in full from every rank's part ----
    C = di + 2 * N
    cs = state.conv
    split = cs.shape[-1] != C
    if split:
        cs = sharding.all_gather_dim(cs, cs.dim() - 1,
                                     sharding.axis_group("model"))
    xp = torch.cat([cs.to(xBC.dtype), xBC_all], dim=1)
    conv_state = xp[:, xp.shape[1] - (cfg.ssm_conv - 1):]
    if split:
        conv_state = conv_state[..., r * (C // n):(r + 1) * (C // n)]
    xBC_t, _ = _causal_conv(
        xBC, conv_w, torch.cat([cs[..., heads], cs[..., di:]], dim=-1))
    xs = xBC_t[:, 0, :dl].reshape(B, Hl, P)
    y, ssd_state = ops.ssd_step(state.ssd, xs, dt[:, 0], A,
                                xBC_t[:, 0, dl:dl + N], xBC_t[:, 0, dl + N:])
    y = (y + xs * D[None, :, None]).to(h.dtype)
    y = _gated_norm_tp(p, y.reshape(B, 1, dl), z, cfg, heads)
    return sharding.reduce_from(y @ sharding.local(p.ssm_out, 0)
                                ).to(h.dtype), \
        SSMState(conv_state.to(state.conv.dtype),
                 ssd_state.to(state.ssd.dtype))


def _gated_norm_tp(p: SSM, y: torch.Tensor, z: torch.Tensor,
                   cfg: ArchConfig, heads: slice) -> torch.Tensor:
    """``rms_norm(gnorm, y * silu(z))`` over all di channels, of which
    this rank holds `heads`: the sum of squares is added over `model`."""
    g = y * F.silu(z)
    gf = g.float()
    ss = sharding.all_sum(torch.sum(gf * gf, dim=-1, keepdim=True))
    out = gf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    w = sharding.local(p.gnorm, 0)
    return (out * (1.0 + w.float())).to(g.dtype)


def init_ssm_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   device, lead: Tuple[int, ...] = ()) -> SSMState:
    """Zero decode state; `lead` prepends axes (layers, groups)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    kw = dict(dtype=dtype, device=device)
    return SSMState(
        conv=torch.zeros(lead + (batch, cfg.ssm_conv - 1, di + 2 * N), **kw),
        ssd=torch.zeros(lead + (batch, H, P, N), **kw))

"""Mamba2 (SSD — state-space duality) block, chunked-scan implementation.

A copy of ``repro.models.mamba2`` in PyTorch (arXiv:2405.21060 §6): the
sequence is split into chunks of length Q; within a chunk the dual
"attention-like" quadratic form is used, across chunks a linear
recurrence on the (H, P, N) state is carried by a Python loop over the
chunks. ``ssd_reference`` is the sequential oracle the tests use.

Shapes: d_inner = expand*d_model, H = d_inner/headdim (heads), P = headdim,
N = ssm_state, G = ssm_ngroups (B/C groups).

``repro`` computes all of this in plain ``jnp``, outside any Pallas kernel,
so the port keeps it in plain torch. Conventions that keep the two equal:

* a product ``repro`` takes on bf16 operands with fp32 accumulation
  (``preferred_element_type=float32``) rounds its operands to bf16, widens
  them and multiplies in fp32 — exact per product, so only the summation
  order differs (a bf16 ``torch.einsum`` would round its output);
* ``softplus`` is ``jax.nn.softplus``'s ``logaddexp(x, 0)``, not
  ``F.softplus`` (which switches to ``x`` above 20);
* groups broadcast to heads as ``jnp.repeat`` does (each group repeated
  H/G times, adjacent), through ``expand`` so a CUDA graph can capture it;
* the prefill conv (:func:`_conv1d`) is an elementwise sum in the
  activation dtype, the decode conv an einsum over the window, each as
  ``repro`` writes it.

The functions are pure: they return new tensors, and the callers
(``models.hybrid``) write the caches in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dssoftmax import normal_
from repro_torch.models.layers import rmsnorm


def init_mamba2(generator: torch.Generator, cfg: ModelConfig, L: int, device="cuda"):
    """Seeded params of ``L`` stacked Mamba2 blocks, each leaf ``(L, …)``,
    with ``repro``'s shapes, dtypes and init scales."""
    d, di = cfg.d_model, cfg.d_inner
    H, N, G = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    conv_dim = di + 2 * G * N
    dt, gen = cfg.jdtype, generator

    def dense(shape, fan_in):
        return normal_(torch.empty((L,) + shape, dtype=dt, device=device), gen,
                       1.0 / math.sqrt(fan_in))

    f32 = dict(dtype=torch.float32, device=device)
    conv_w = normal_(torch.empty((L, cfg.ssm_conv_width, conv_dim), **f32), gen, 0.1)
    return {
        "in_zx": dense((d, 2 * di), d),
        "in_bc": dense((d, 2 * G * N), d),
        "in_dt": dense((d, H), d),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((L, conv_dim), dtype=dt, device=device),
        # A stored as log(-A) per head (A negative); dt bias via softplus inv.
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).expand(L, H).clone(),
        "dt_bias": torch.full((L, H), math.log(math.expm1(0.01)), **f32),
        "D": torch.ones((L, H), **f32),
        "norm_scale": torch.ones((L, di), **f32),
        "out_proj": dense((di, d), di),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def repeat_groups(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, rep, axis=dim)``: each entry of ``dim`` repeated
    ``rep`` times, adjacent (groups → heads)."""
    if rep == 1:
        return t
    dim = dim % t.dim()
    shape = list(t.shape)
    t = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep, *shape[dim + 1:])
    return t.reshape(*shape[:dim], shape[dim] * rep, *shape[dim + 1:])


def _bf16_f32(t: torch.Tensor) -> torch.Tensor:
    """An operand of a bf16 × bf16 → fp32 product: rounded to bf16, widened."""
    return t.to(torch.bfloat16).float()


def _in_proj(params, cfg: ModelConfig, u: torch.Tensor):
    """u: (..., d) → (z, x, B, C, dt) streams."""
    di, G, N = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    zx = u @ params["in_zx"]
    bc = u @ params["in_bc"]
    dt = u @ params["in_dt"]
    return zx[..., :di], zx[..., di:], bc[..., :G * N], bc[..., G * N:], dt


def _conv1d(w, b, x):
    """Depthwise causal conv, width W. The first W-1 rows of ``x`` are the
    left context (the previous chunk's pre-conv tail, or zeros for a cold
    start) and are dropped from the output: (B, W-1+S, C) → (B, S, C). The
    sum runs in the activation dtype, the SiLU in fp32."""
    W = w.shape[0]
    S_out = x.shape[1] - (W - 1)
    out = x[:, 0:S_out] * w[0]
    for i in range(1, W):
        out = out + x[:, i:i + S_out] * w[i]
    return F.silu((out + b).float()).to(x.dtype)


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD. x: (b,S,H,P), dt: (b,S,H) (post-softplus), A: (H,) (<0),
    B,C: (b,S,G,N). Returns y: (b,S,H,P) fp32 and the final state (b,H,P,N).

    ``initial_state`` (b,H,P,N) seeds the inter-chunk recurrence; None is a
    zero state. A tail that is not a chunk multiple is padded with ``dt = 0``
    steps, exact no-ops in the recurrence (decay exp(0·A)=1, no input)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        zpad = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        x, dt, B, C = zpad(x), zpad(dt), zpad(B), zpad(C)
    Sp = S + pad
    nc = Sp // Q
    rep = H // G
    x = x.reshape(b, nc, Q, H, P)
    dt = dt.reshape(b, nc, Q, H)
    Bm = B.reshape(b, nc, Q, G, N)
    Cm = C.reshape(b, nc, Q, G, N)

    dA = dt * A[None, None, None, :]          # (b,nc,Q,H) log-decay per step, <=0
    cum = torch.cumsum(dA, dim=2)             # within-chunk inclusive cumsum
    total = cum[:, :, -1, :]                  # (b,nc,H)

    # --- intra-chunk (dual quadratic form) ---
    # L[i,j] = exp(cum_i - cum_j) for i >= j else 0 (decay from j+1..i);
    # CB and (CB·L)·xdt take bf16 operands with fp32 accumulation
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b,nc,Qi,Qj,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(causal[None, None, :, :, None], torch.exp(diff), 0.0)
    CB = torch.einsum("bcign,bcjgn->bcijg", _bf16_f32(Cm), _bf16_f32(Bm))
    CB = repeat_groups(CB, rep, -1)           # groups -> heads (b,nc,Qi,Qj,H)
    xdt = x.float() * dt[..., None]           # (b,nc,Q,H,P)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", _bf16_f32(CB * L), _bf16_f32(xdt))

    # --- chunk states: states_c = Σ_j exp(total - cum_j)·dt_j·B_j ⊗ x_j ---
    decay_to_end = torch.exp(total[:, :, None, :] - cum)      # (b,nc,Q,H)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_to_end,
                          repeat_groups(Bm.float(), rep, -2), xdt)

    # --- inter-chunk recurrence: the state ENTERING each chunk ---
    carry = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(total[:, c])[..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)    # (b,nc,H,P,N)

    # --- inter-chunk contribution: y_off_i = (C_i · state_in) * exp(cum_i) ---
    Ch = repeat_groups(Cm.float(), rep, -2)   # (b,nc,Q,H,N)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, prev_states, torch.exp(cum))
    y = (y_diag + y_off).reshape(b, Sp, H, P)
    return y[:, :S], carry


def ssd_reference(x, dt, A, B, C):
    """Sequential-scan oracle (tests): ``ssd_chunked``'s signature minus
    chunking."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = repeat_groups(B, rep, 2).float()
    Ch = repeat_groups(C, rep, 2).float()
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)       # (b,H)
        state = state * decay[..., None, None] + torch.einsum(
            "bhn,bhp,bh->bhpn", Bh[:, t], x[:, t].float(), dt[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1), state


def mamba2_block(params, cfg: ModelConfig, u: torch.Tensor, *, return_state: bool = False):
    """Full Mamba2 block over a sequence. u: (B, S, d) → (B, S, d).

    With ``return_state``, also returns ``(conv_tail, ssm_state)`` for the
    prefill→decode handoff: conv_tail (B, W-1, conv_dim) the pre-conv input
    tail, ssm_state (B, H, P, N) fp32 the final recurrent state. A whole
    sequence is the degenerate chunk: zero incoming state, every row valid."""
    Bsz, S, _ = u.shape
    H, P, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    conv_dim = cfg.d_inner + 2 * G * N
    conv0 = torch.zeros((Bsz, cfg.ssm_conv_width - 1, conv_dim), dtype=u.dtype, device=u.device)
    ssm0 = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=u.device)
    out, conv_tail, final = mamba2_prefill_chunk(params, cfg, u, conv0, ssm0, S)
    if return_state:
        return out, (conv_tail, final)
    return out


def mamba2_prefill_chunk(params, cfg: ModelConfig, u, conv_state, ssm_state, n_valid):
    """One fixed-shape prompt chunk with incoming state (chunked prefill).

    u: (B, C, d) chunk inputs; conv_state: (B, W-1, conv_dim), the previous
    chunk's pre-conv tail (zeros for the first chunk); ssm_state: (B, H, P,
    N) fp32, the state entering the chunk. Rows at or past ``n_valid`` (an
    int, or a (B,) int tensor of per-row counts: the commit case, where each
    slot advances by its own accepted length) are right-padding: their
    post-softplus ``dt`` is masked to 0 (an exact no-op in the recurrence)
    and the returned conv tail ends at the last valid row. Outputs at padded
    rows are garbage. Returns (out, new_conv_state, new_ssm_state)."""
    Bsz, Cn, _ = u.shape
    H, P, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    W, di = cfg.ssm_conv_width, cfg.d_inner
    z, x, Bc, Cc, dt = _in_proj(params, cfg, u)
    xBC_pre = torch.cat([x, Bc, Cc], dim=-1)
    full = torch.cat([conv_state.to(xBC_pre.dtype), xBC_pre], dim=1)
    xBC = _conv1d(params["conv_w"], params["conv_b"], full)
    x = xBC[..., :di].reshape(Bsz, Cn, H, P)
    Bc = xBC[..., di:di + G * N].reshape(Bsz, Cn, G, N)
    Cc = xBC[..., di + G * N:].reshape(Bsz, Cn, G, N)
    dt = softplus(dt.float() + params["dt_bias"])               # (B,C,H)
    steps = torch.arange(Cn, device=u.device)
    per_row = torch.is_tensor(n_valid) and n_valid.dim() == 1
    if per_row:
        nv = n_valid.to(u.device).long()
        valid = steps[None, :] < nv[:, None]
    else:
        valid = (steps < int(n_valid))[None, :]
    dt = torch.where(valid[:, :, None], dt, 0.0)
    A = -torch.exp(params["A_log"])
    y, final = ssd_chunked(x, dt, A, Bc, Cc, cfg.ssm_chunk, initial_state=ssm_state)
    y = y + x.float() * params["D"][None, None, :, None]
    y = y.reshape(Bsz, Cn, di)
    y = y * F.silu(z.float())
    y = rmsnorm({"scale": params["norm_scale"]}, y.to(u.dtype), cfg.norm_eps)
    out = y @ params["out_proj"]
    # ``full`` row W-1+i is chunk row i, so the W-1 rows ending at the last
    # valid row start at full index ``n_valid``
    if per_row:
        idx = nv[:, None] + torch.arange(W - 1, device=u.device)[None, :]   # (B, W-1)
        new_conv = full[torch.arange(Bsz, device=u.device)[:, None], idx]
    else:
        new_conv = full[:, int(n_valid):int(n_valid) + W - 1]
    return out, new_conv, final


def mamba2_verify_scan(params, cfg: ModelConfig, u, conv_state, ssm_state, n_valid):
    """:func:`mamba2_decode`'s per-token update unrolled over a (B, W) block:
    the speculative verify and commit path of the state families.

    Unlike :func:`mamba2_prefill_chunk` (the SSD dual form, whose
    exp-of-cumsum decays and bf16 intra-chunk products are not the one-token
    recurrence), each step here is the decode step itself, so state
    committed here equals plain one-token decoding. Rows at or past
    ``n_valid`` (an int or a (B,) tensor: each slot's accepted prefix in the
    commit pass) keep the carried conv/ssm state (a select, no arithmetic).
    Outputs at those rows are garbage. Returns (out (B, W, d),
    new_conv_state, new_ssm_state)."""
    B, W, _ = u.shape
    if torch.is_tensor(n_valid) and n_valid.dim() == 1:
        nv = n_valid.to(u.device).long()
    else:
        nv = torch.full((B,), int(n_valid), dtype=torch.long, device=u.device)
    conv, ssm = conv_state, ssm_state
    outs = []
    for j in range(W):
        out, nconv, nssm = mamba2_decode(params, cfg, u[:, j:j + 1].contiguous(), conv, ssm)
        keep = j < nv                                           # (B,)
        conv = torch.where(keep[:, None, None], nconv, conv)
        ssm = torch.where(keep[:, None, None, None], nssm, ssm)
        outs.append(out[:, 0])
    return torch.stack(outs, dim=1), conv, ssm


def mamba2_decode(params, cfg: ModelConfig, u, conv_state, ssm_state):
    """One-token decode. u: (B,1,d); conv_state: (B, W-1, conv_dim);
    ssm_state: (B,H,P,N) fp32. Returns (out, new_conv_state, new_ssm_state)."""
    Bsz = u.shape[0]
    H, P, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    di = cfg.d_inner
    z, x, Bc, Cc, dt = _in_proj(params, cfg, u[:, 0])
    xBC = torch.cat([x, Bc, Cc], dim=-1)                        # (B, conv_dim)
    window = torch.cat([conv_state, xBC[:, None, :]], dim=1)    # (B, W, conv)
    new_conv_state = window[:, 1:]
    # a dot in the activation dtype: fp32 sums, one rounding
    conv_out = torch.einsum("bwc,wc->bc", window.float(),
                            params["conv_w"].float()).to(u.dtype) + params["conv_b"]
    xBC = F.silu(conv_out.float()).to(u.dtype)
    x = xBC[:, :di].reshape(Bsz, H, P)
    Bc = xBC[:, di:di + G * N].reshape(Bsz, G, N)
    Cc = xBC[:, di + G * N:].reshape(Bsz, G, N)
    rep = H // G
    Bh = repeat_groups(Bc, rep, 1).float()
    Ch = repeat_groups(Cc, rep, 1).float()
    dt = softplus(dt.float() + params["dt_bias"])               # (B,H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)                                   # (B,H)
    ssm_state = ssm_state * decay[..., None, None] + torch.einsum(
        "bhn,bhp,bh->bhpn", Bh, x.float(), dt)
    y = torch.einsum("bhn,bhpn->bhp", Ch, ssm_state)
    y = y + x.float() * params["D"][None, :, None]
    y = y.reshape(Bsz, di) * F.silu(z.float())
    y = rmsnorm({"scale": params["norm_scale"]}, y.to(u.dtype), cfg.norm_eps)
    out = (y @ params["out_proj"])[:, None, :]
    return out, new_conv_state, ssm_state

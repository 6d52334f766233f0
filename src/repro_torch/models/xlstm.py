"""xLSTM blocks [arXiv:2405.04517] and the xlstm-1.3b backbone: params,
training loss, recurrent state and forward_chunk.

The PyTorch counterpart of `repro/models/xlstm.py` (family="ssm"): the
same param names, layouts and dtypes (the reference's leaf names load as
they are) and the same static cost edges.  The reference has no Pallas
kernel here: its scans are plain JAX (`lax.scan`, `associative_scan`),
and so are the port's, in plain torch.  Its norms run the rmsnorm kernel.

mLSTM cell per head (matrix memory C, normalizer n, stabilizer m):
    C_t = f_t C_{t-1} + i_t v_t k_t^T,  n_t = f_t n_{t-1} + i_t k_t,
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))
with log f = log sigmoid(f~), log i = i~, every gate scaled by exp(-m_t),
m_t = max(log f_t + m_{t-1}, log i_t).  Training and prefill run the
chunkwise-parallel form (`_mlstm_cell_chunked`: quadratic inside a chunk,
(C, n, m) carried across chunks), held in tests to the sequential oracle
`_mlstm_cell_seq`; a decode tick runs the one-step recurrence.  The
sLSTM (`_slstm_scan`) is sequential by construction: a loop over time.

Layout (xLSTM[7:1]): n_layers // slstm_every super-blocks of
slstm_every - 1 mLSTM blocks and one sLSTM block; params stacked
p["stack_mlstm"]["stack"] [n_super, n_m, ...] and
p["stack_slstm"]["stack"] [n_super, ...]; d_ff = 0, the projections live
in the blocks.  Where the reference scans, the port loops; each block
registers its own costs.  Each super-block is rematerialized per
cfg.remat, as the reference checkpoints its super_body.

Serving state is O(1) in sequence length: {"mlstm": {"C" [n_super * n_m,
B, H, ph, ph], "n" [.., B, H, ph], "m" [.., B, H]}, "slstm": {"c", "n",
"m", "h": [n_super, B, d]}}, all f32 — the reference's (C, n, m) and
(c, n, m, h) tuples, the mLSTM's two layer axes merged so that every
leaf's batch axis is 1, as the serving engine takes it.  `forward_chunk`
updates it IN PLACE.  There are no paged entry points.

Under a model axis (training; `parallel.sharding.layout_tree`) both
blocks are tensor parallel by heads.  mLSTM: `w_up` gives this rank's
heads' columns of x and of z (a `Segmented` leaf), w_q/k/v and the skip
hold its heads, and it takes its heads' f and i columns of the whole
`w_gates`, whose gradient is then summed over 'model' once
(`tp.copy_to_model`); the chunked cell runs on its heads and the block
ends in the row-parallel `w_down`.  sLSTM: w_{i,f,z,o} give its heads'
columns and r_* hold its heads, so the loop runs on them; the block has
no out projection, so y is gathered over 'model' before the residual
add.  Its gated FFN is split (column-parallel in, row-parallel out)
when its width divides the model axis, else every rank runs it whole
(xlstm-1.3b's 2730 at 'model' 4).  The normed input enters each split
projection through `copy_to_model`.  Each block runs inside XFA's
`mlstm` or `slstm` component scope, so its collectives are recorded
under it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import hlo_flows
from ..core.device_fold import DeviceFoldSpec, annotate_cost
from ..parallel import tp
from ..parallel.axes import get_runtime_mesh
from .layers import (Params, Runtime, embed, last_valid, linear, lm_head,
                     norm)
from .transformer import ONES, _remat, _unstack, init_from_specs, lm_loss

#: log i of a pad step: nothing is injected (the reference's -1e30)
NEG = -1e30


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(n_super, n_m, mLSTM inner width di, mLSTM head width ph)."""
    di = int(cfg.d_model * cfg.mlstm_proj_factor)
    return (cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1, di,
            di // cfg.n_heads)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Spec tree of the xLSTM params (see transformer.param_specs), with
    the reference's inits: fan_in ** -0.5 normals, the per-head q/k/v and
    recurrent matrices at head_width ** -0.5, the gate projection at
    d ** -0.5, the skip and norm scales 1."""
    if cfg.family != "ssm" or cfg.slstm_every < 2:
        raise ValueError(f"{cfg.name}: not an xLSTM config with slstm_every")
    d, H = cfg.d_model, cfg.n_heads
    n_super, n_m, di, ph = _dims(cfg)
    ms, ss = (n_super, n_m), (n_super,)

    def w(lead, fan_in, *shape, scale=None):
        return (lead + shape, fan_in ** -0.5 if scale is None else scale)

    mlstm = {"w_up": w(ms, d, d, 2 * di),
             "w_q": w(ms, 0, H, ph, ph, scale=ph ** -0.5),
             "w_k": w(ms, 0, H, ph, ph, scale=ph ** -0.5),
             "w_v": w(ms, 0, H, ph, ph, scale=ph ** -0.5),
             "w_gates": w(ms, d, d, 2 * H),
             "w_down": w(ms, di, di, d),
             "skip": (ms + (di,), ONES)}
    sp = d // H
    f_ffn = int(d * 4 / 3)
    slstm: Dict[str, Any] = {}
    for g in "ifzo":
        slstm[f"w_{g}"] = w(ss, d, d, d)
        slstm[f"r_{g}"] = w(ss, 0, H, sp, sp, scale=sp ** -0.5)
    slstm.update(ffn_gate=w(ss, d, d, f_ffn), ffn_up=w(ss, d, d, f_ffn),
                 ffn_down=w(ss, f_ffn, f_ffn, d))
    specs: Dict[str, Any] = {
        "embed": {"table": ((cfg.vocab, d), 1.0)},
        "final_norm": {"scale": ((d,), ONES)},
        "stack_mlstm": {"stack": {"norm1": {"scale": (ms + (d,), ONES)},
                                  "mlstm": mlstm}},
        "stack_slstm": {"stack": {"norm1": {"scale": (ss + (d,), ONES)},
                                  "norm2": {"scale": (ss + (d,), ONES)},
                                  "slstm": slstm}},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": w((), d, d, cfg.vocab)}
    return specs


def init_params(cfg: ModelConfig, seed: int, device: torch.device) -> Params:
    return init_from_specs(param_specs(cfg), cfg, seed, device)


# ---------------------------------------------------------------- mLSTM ----
def _zero_mlstm(B: int, H: int, ph: int, device) -> Tuple[torch.Tensor, ...]:
    return (torch.zeros((B, H, ph, ph), dtype=torch.float32, device=device),
            torch.zeros((B, H, ph), dtype=torch.float32, device=device),
            torch.full((B, H), NEG, dtype=torch.float32, device=device))


def _mlstm_cell_seq(q, k, v, logf, logi):
    """The sequential stabilized oracle.  q/k/v: [B, H, L, ph]; logf/logi:
    [B, H, L].  Returns (y [B, H, L, ph] f32, state (C, n, m))."""
    B, H, L, ph = q.shape
    C, n, m = _zero_mlstm(B, H, ph, q.device)
    q, k, v, logf, logi = (a.float() for a in (q, k, v, logf, logi))
    ys = []
    for t in range(L):
        lf, li = logf[:, :, t], logi[:, :, t]
        m_new = torch.maximum(lf + m, li)
        f_eff = torch.exp(lf + m - m_new)
        i_eff = torch.exp(li - m_new)
        C = f_eff[..., None, None] * C + i_eff[..., None, None] \
            * (v[:, :, t, :, None] * k[:, :, t, None, :])
        n = f_eff[..., None] * n + i_eff[..., None] * k[:, :, t]
        num = torch.einsum("bhvk,bhk->bhv", C, q[:, :, t])
        den = torch.abs(torch.einsum("bhk,bhk->bh", n, q[:, :, t]))
        den = torch.maximum(den, torch.exp(-m_new))
        ys.append(num / den[..., None])
        m = m_new
    return torch.stack(ys, dim=2), (C, n, m)


def _mlstm_cell_chunked(q, k, v, logf, logi, chunk: int, state=None):
    """Chunkwise-parallel stabilized mLSTM; shapes as _mlstm_cell_seq,
    state (C, n, m) to resume from (None: zeros, m = -1e30).

    Per chunk of length T, with cum the inclusive cumsum of log f:
      m_t    = cum_t + max(m_prev, runmax_{s<=t}(log i_s - cum_s))
      intra  w[t, s] = exp(cum_t - cum_s + log i_s - m_t) (q_t . k_s), s <= t
      inter  exp(cum_t + m_prev - m_t) (C_prev q_t)
    and (C, n, m) carried to the next chunk.  A length that is no chunk
    multiple is padded with log f = 0 and log i = -1e30, which leave the
    state as it was."""
    B, H, L, ph = q.shape
    pad = (-L) % chunk
    q, k, v = (a.float() for a in (q, k, v))
    logf, logi = logf.float(), logi.float()
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        logf = F.pad(logf, (0, pad))
        logi = F.pad(logi, (0, pad), value=NEG)
    nc = (L + pad) // chunk

    def rs(a):
        return a.reshape(B, H, nc, chunk, *a.shape[3:])
    qc, kc, vc, lfc, lic = (rs(a) for a in (q, k, v, logf, logi))
    cum = torch.cumsum(lfc, dim=3)
    runmax = torch.cummax(lic - cum, dim=3).values
    csum = cum[..., -1]
    C, n, m = _zero_mlstm(B, H, ph, q.device) if state is None else state
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    ys = []
    for c in range(nc):
        q_k, k_k, v_k = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        cum_k, li_k = cum[:, :, c], lic[:, :, c]
        m_t = cum_k + torch.maximum(m[..., None], runmax[:, :, c])
        a = cum_k[..., :, None] + (li_k - cum_k)[..., None, :]
        # masked before the exp: exp(-1e30) is the reference's 0, and an
        # overflow above the diagonal cannot reach the backward as 0 * inf
        w = torch.exp(torch.where(tri, a - m_t[..., :, None], NEG))
        sw = (q_k @ k_k.transpose(-1, -2)) * w               # [B,H,T,T]
        dec = torch.exp(cum_k + m[..., None] - m_t)          # [B,H,T]
        num = sw @ v_k + dec[..., None] * (q_k @ C.transpose(-1, -2))
        den = sw.sum(-1) + dec * (q_k @ n[..., None])[..., 0]
        den = torch.maximum(torch.abs(den), torch.exp(-m_t))
        ys.append(num / den[..., None])
        m_end = m_t[..., -1]
        w_in = torch.exp(cum_k[..., -1:] - cum_k + li_k - m_end[..., None])
        carry = torch.exp(csum[:, :, c] + m - m_end)
        C = carry[..., None, None] * C \
            + (v_k * w_in[..., None]).transpose(-1, -2) @ k_k
        n = carry[..., None] * n + (w_in[..., None] * k_k).sum(2)
        m = m_end
    y = torch.stack(ys, dim=2).reshape(B, H, nc * chunk, ph)
    return y[:, :, :L], (C, n, m)


def _mlstm_cell_step(q, k, v, logf, logi, state):
    """One decode step.  q/k/v: [B, H, ph]; logf/logi: [B, H] f32."""
    C, n, m = state
    m_new = torch.maximum(logf + m, logi)
    f_eff = torch.exp(logf + m - m_new)
    i_eff = torch.exp(logi - m_new)
    C = f_eff[..., None, None] * C \
        + i_eff[..., None, None] * (v[..., :, None] * k[..., None, :]).float()
    n = f_eff[..., None] * n + i_eff[..., None] * k.float()
    num = torch.einsum("bhvk,bhk->bhv", C, q.float())
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q.float())),
                        torch.exp(-m_new))
    return num / den[..., None], (C, n, m_new)


def _pad_mask(L: int, valid: torch.Tensor, device) -> torch.Tensor:
    """[B, L]: True on the real steps of a bucket-padded chunk."""
    return torch.arange(L, device=device)[None, :] \
        < valid.to(device)[:, None]


def _serving_split(split: bool, state) -> None:
    if split and state is not None:
        raise NotImplementedError("the xLSTM's serving path under a model "
                                  "axis is not ported")


@hlo_flows.scoped("mlstm")
def mlstm_block(p: Params, x: torch.Tensor, rt: Runtime, state=None,
                valid: Optional[torch.Tensor] = None):
    """x: [B, L, d] -> (the block's output [B, L, d] (the caller adds the
    residual), the new (C, n, m) or None without a state).  state None
    is full-sequence mode; with a state, L == 1 is the one-step
    recurrence and L > 1 the chunked form resuming from it.  valid: [B]
    real-token counts of a bucket-padded chunk; pad steps get log f = 0
    and log i = -1e30, so (C, n, m) pass through them.  Under a model
    axis (training only) the block runs this rank's heads (see the
    module docstring)."""
    cfg = rt.cfg
    mp = p["mlstm"]
    B, L, d = x.shape
    _, _, di_all, ph = _dims(cfg)
    # local heads from the weights: a model axis holds H / tp a rank
    H = mp["w_q"].shape[-3]
    di = H * ph
    split = tp.split_over_model(H, cfg.n_heads)
    _serving_split(split, state)
    h = norm(p["norm1"], x, rt)
    w_gates = mp["w_gates"]
    if split:
        # the whole w_gates meets only this rank's heads' f and i columns
        h, w_gates = tp.copy_to_model(h), tp.copy_to_model(w_gates)
        first = tp.model_coord() * H
        w_gates = torch.cat([w_gates[..., first:first + H],
                             w_gates[..., cfg.n_heads + first:
                                     cfg.n_heads + first + H]], dim=-1)
    up = linear(mp["w_up"], h)
    xin, z = up[..., :di], up[..., di:]
    gates = linear(w_gates, h).float()                     # [B, L, 2H]
    logf = F.logsigmoid(gates[..., :H]).transpose(1, 2)   # [B, H, L]
    logi = gates[..., H:].transpose(1, 2)
    if valid is not None:
        real = _pad_mask(L, valid, x.device)[:, None]
        logf = torch.where(real, logf, 0.0)
        logi = torch.where(real, logi, NEG)
    xh = xin.reshape(B, L, H, ph).transpose(1, 2)         # [B, H, L, ph]
    q = torch.einsum("bhld,hde->bhle", xh, mp["w_q"].to(xh.dtype))
    k = torch.einsum("bhld,hde->bhle", xh, mp["w_k"].to(xh.dtype)) \
        * ph ** -0.5
    v = torch.einsum("bhld,hde->bhle", xh, mp["w_v"].to(xh.dtype))
    annotate_cost("mlstm", "mlstm", "proj",
                  flops=2.0 * B * L * (d * 2 * di_all + 3 * di_all * ph
                                       + d * 2 * cfg.n_heads + di_all * d))
    if state is None or L > 1:
        y, new_state = _mlstm_cell_chunked(
            q, k, v, logf, logi, chunk=min(cfg.ssm_chunk, max(L, 1)),
            state=state)
    else:
        y, new_state = _mlstm_cell_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                        logf[:, :, 0], logi[:, :, 0], state)
        y = y[:, :, None]
    y = y.transpose(1, 2).reshape(B, L, di).to(x.dtype)
    y = y + mp["skip"].to(x.dtype) * xin
    y = y * F.silu(z.float()).to(x.dtype)
    out = (tp.row_parallel(y, mp["w_down"]) if split
           else linear(mp["w_down"], y))
    return out, (new_state if state is not None else None)


# ---------------------------------------------------------------- sLSTM ----
def _zero_slstm(B: int, d: int, device) -> Tuple[torch.Tensor, ...]:
    z = lambda: torch.zeros((B, d), dtype=torch.float32, device=device)
    return z(), z(), torch.full((B, d), NEG, dtype=torch.float32,
                                device=device), z()


def _slstm_loop(pre: torch.Tensor, rh: torch.Tensor, state,
                mask: Optional[torch.Tensor] = None, keep: bool = False):
    """The sLSTM steps.  pre: [L, H, B, 4, ph] the gates' input
    pre-activations (i, f, z, o); rh: [H, ph, 4 ph] the per-head
    recurrent weights of the four gates side by side; state (c, n, m, h)
    head-major [H, B, ph]; mask: [B, L], True on real steps (a pad step
    passes every carry through).  Returns (h of each step [L, H, B, ph],
    the final state, and with `keep` what _SLSTMScan's backward reads:
    the gates, log f + m, the effective gates, tanh z, sigmoid o, the
    clamped normalizer, and c, n, h from the initial state on)."""
    L, H, B = pre.shape[:3]
    c, n, m, h = state
    hist = {k: [] for k in ("gi", "lfm", "i_eff", "f_eff", "tz", "so",
                            "nc")}
    cs, ns, hs = [c], [n], [h]
    for t in range(L):
        gi = pre[t] + torch.bmm(h, rh).view(H, B, 4, -1)
        it, ft, zt, ot = gi.unbind(2)
        lfm = F.logsigmoid(ft) + m
        m_new = torch.maximum(lfm, it)
        i_eff = torch.exp(it - m_new)
        f_eff = torch.exp(lfm - m_new)
        tz = torch.tanh(zt)
        c_new = torch.addcmul(f_eff * c, i_eff, tz)
        n_new = torch.addcmul(i_eff, f_eff, n)
        so = torch.sigmoid(ot)
        nc = torch.clamp(n_new, min=1e-6)
        h_new = so * c_new / nc
        if mask is not None:
            mb = mask[None, :, t, None]
            c_new = torch.where(mb, c_new, c)
            n_new = torch.where(mb, n_new, n)
            m_new = torch.where(mb, m_new, m)
            h_new = torch.where(mb, h_new, h)
        if keep:
            for k, v in zip(hist, (gi, lfm, i_eff, f_eff, tz, so, nc)):
                hist[k].append(v)
        c, n, m, h = c_new, n_new, m_new, h_new
        cs.append(c)
        ns.append(n)
        hs.append(h)
    ys = torch.stack(hs[1:])
    if not keep:
        return ys, (c, n, m, h), None
    kept = {k: torch.stack(v) for k, v in hist.items()}
    kept.update(c=torch.stack(cs), n=torch.stack(ns), h=torch.stack(hs))
    return ys, (c, n, m, h), kept


_KEPT = ("gi", "lfm", "i_eff", "f_eff", "tz", "so", "nc", "c", "n", "h")


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM loop with its backward written out (plain torch): the
    forward keeps each step's gates and states, the backward walks the
    steps in reverse.  Autograd records one node for the loop instead of
    ~15 a step, whose bookkeeping would cost more host time than the
    steps' own small kernels.  apply(pre, rh, c, n, m, h) -> (ys, c, n,
    m, h), shapes as _slstm_loop's; no pad mask (training)."""

    @staticmethod
    def forward(ctx, pre, rh, c, n, m, h):
        ys, state, kept = _slstm_loop(pre, rh, (c, n, m, h), keep=True)
        ctx.save_for_backward(rh, *(kept[k] for k in _KEPT))
        return (ys,) + state

    @staticmethod
    def backward(ctx, dys, dc, dn, dm, dh):
        rh, *saved = ctx.saved_tensors
        k = dict(zip(_KEPT, saved))
        L, H, B, _, ph = k["gi"].shape
        rh_t = rh.transpose(1, 2)
        sig_bwd = torch.ops.aten.sigmoid_backward
        tanh_bwd = torch.ops.aten.tanh_backward
        dgis = []
        for t in reversed(range(L)):
            it, ft, _, _ = k["gi"][t].unbind(2)
            f_eff, i_eff, tz = k["f_eff"][t], k["i_eff"][t], k["tz"][t]
            q = (dys[t] + dh) / k["nc"][t]
            dot = sig_bwd(q * k["c"][t + 1], k["so"][t])
            dc = torch.addcmul(dc, q, k["so"][t])
            dn = dn - q * k["h"][t + 1] * (k["n"][t + 1] >= 1e-6)
            df = torch.addcmul(dc * k["c"][t], dn, k["n"][t])
            di = torch.addcmul(dn, dc, tz)
            dzt = tanh_bwd(dc * i_eff, tz)
            a, b = df * f_eff, di * i_eff
            dmn = dm - a - b
            sel = k["lfm"][t] >= it
            dlfm = a + torch.where(sel, dmn, 0.0)
            dit = b + torch.where(sel, 0.0, dmn)
            dgi = torch.stack([dit, dlfm * torch.sigmoid(-ft), dzt, dot], 2)
            dgis.append(dgi)
            dh = torch.bmm(dgi.view(H, B, 4 * ph), rh_t)
            dc, dn, dm = dc * f_eff, dn * f_eff, dlfm
        dpre = torch.stack(dgis[::-1])                   # [L, H, B, 4, ph]
        hs = k["h"][:L].permute(1, 0, 2, 3).reshape(H, L * B, ph)
        drh = torch.bmm(hs.transpose(1, 2),
                        dpre.permute(1, 0, 2, 3, 4).reshape(H, L * B, 4 * ph))
        return dpre, drh, dc, dn, dm, dh


def _slstm_scan(sp: Params, x: torch.Tensor, cfg: ModelConfig, state,
                mask: Optional[torch.Tensor] = None):
    """x: [B, L, d]; the sequential stabilized sLSTM from state (c, n, m,
    h) [B, d] each, a loop over time.  mask: [B, L], True on real steps;
    at a pad step every carry passes through (serving: a pad mask takes
    no gradient).  Returns (y [B, L, d] f32, state).  Inside the loop the
    carries are head-major [H, B, ph], so a step's recurrent product for
    the four gates is one batched matmul; with a gradient wanted the loop
    runs as _SLSTMScan.  Under a model axis `sp` holds this rank's
    heads (r_* [H / tp, ph, ph], w_* their columns): the loop runs on
    them, and y and the state are this rank's [.., d / tp]."""
    B, L, _ = x.shape
    H, ph = sp["r_i"].shape[-3], sp["r_i"].shape[-1]
    d = H * ph
    wi = torch.stack([sp["w_i"], sp["w_f"], sp["w_z"], sp["w_o"]]).float()
    ri = torch.stack([sp["r_i"], sp["r_f"], sp["r_z"], sp["r_o"]]).float()
    rh = ri.permute(1, 2, 0, 3).reshape(H, ph, 4 * ph)    # [H, ph, 4 ph]
    pre = torch.einsum("bld,gde->blge", x.float(), wi)     # [B, L, 4, d]
    pre = pre.reshape(B, L, 4, H, ph).permute(1, 3, 0, 2, 4).contiguous()
    st = tuple(a.reshape(B, H, ph).transpose(0, 1).contiguous()
               for a in state)
    if torch.is_grad_enabled() and (pre.requires_grad or rh.requires_grad
                                    or any(a.requires_grad for a in st)):
        if mask is not None:
            raise ValueError("the sLSTM's pad mask is for serving: it takes "
                             "no gradient")
        ys, *st = _SLSTMScan.apply(pre, rh, *st)
    else:
        ys, st, _ = _slstm_loop(pre, rh, st, mask)
    y = ys.permute(2, 0, 1, 3).reshape(B, L, d)
    return y, tuple(a.transpose(0, 1).reshape(B, d) for a in st)


@hlo_flows.scoped("slstm")
def slstm_block(p: Params, x: torch.Tensor, rt: Runtime, state=None,
                valid: Optional[torch.Tensor] = None):
    """x: [B, L, d] -> (x + the sLSTM + its gated FFN, the new (c, n, m,
    h) or None without a state).  Under a model axis (training only) the
    cell runs this rank's heads and its y is gathered over 'model'; the
    FFN is split or whole by its local width (see the module
    docstring)."""
    cfg = rt.cfg
    sp = p["slstm"]
    B, L, d = x.shape
    split = tp.split_over_model(sp["r_i"].shape[-3], cfg.n_heads)
    _serving_split(split, state)
    h = norm(p["norm1"], x, rt)
    if split:
        h = tp.copy_to_model(h)
    st = (state if state is not None
          else _zero_slstm(B, sp["w_i"].shape[-1], x.device))
    mask = None if valid is None else _pad_mask(L, valid, x.device)
    y, new_state = _slstm_scan(sp, h, cfg, st, mask)
    annotate_cost("slstm", "slstm", "cell",
                  flops=2.0 * B * L * (4 * d * d + 4 * d * d
                                       / max(cfg.n_heads, 1)))
    y = y.to(x.dtype)
    if split:
        # no out projection: y joins the residual stream whole
        y = tp.gather_rows(y, get_runtime_mesh(), tp.model_axes()[0],
                           dim=-1)
    x = x + y
    h2 = norm(p["norm2"], x, rt)
    ffn_split = tp.split_over_model(sp["ffn_gate"].shape[-1],
                                    int(d * 4 / 3))
    if ffn_split:
        h2 = tp.copy_to_model(h2)
    g = F.silu(linear(sp["ffn_gate"], h2).float())
    u = linear(sp["ffn_up"], h2).float()
    hidden = (g * u).to(x.dtype)
    x = x + (tp.row_parallel(hidden, sp["ffn_down"]) if ffn_split
             else linear(sp["ffn_down"], hidden))
    return x, (new_state if state is not None else None)


# ----------------------------------------------------------- full model ----
def _super_blocks(p: Params, cfg: ModelConfig):
    """Per super-block (its n_m mLSTM layers' params, its sLSTM's), each
    stacked leaf taken apart once."""
    n_super, n_m, _, _ = _dims(cfg)
    mstacks = _unstack(p["stack_mlstm"]["stack"], n_super)
    sblocks = _unstack(p["stack_slstm"]["stack"], n_super)
    return [(_unstack(ms, n_m), sb) for ms, sb in zip(mstacks, sblocks)]


def forward(p: Params, tokens, rt: Runtime, table):
    """tokens: [B, S] -> (hidden [B, S, d] after the final norm, table,
    aux = 0).  Full-sequence mode, no state; each super-block
    rematerialized per cfg.remat."""
    cfg = rt.cfg
    x = embed(p, torch.as_tensor(tokens, device=rt.device), rt)

    def super_body(mlayers, sblock, x):
        for layer_p in mlayers:
            x = x + mlstm_block(layer_p, x, rt)[0]
        return slstm_block(sblock, x, rt)[0]

    body = _remat(super_body, cfg)
    for mlayers, sblock in _super_blocks(p, cfg):
        x = body(mlayers, sblock, x)
    x = norm(p["final_norm"], x, rt)
    return x, table, torch.zeros((), dtype=torch.float32, device=rt.device)


def loss_fn(p: Params, batch: Dict[str, Any], rt: Runtime, table):
    """The causal LM loss (see `transformer.lm_loss`)."""
    return lm_loss(forward, p, batch, rt, table)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Params:
    """The zero recurrent state (see the module docstring), m at -1e30;
    max_len is ignored: the state is O(1) in sequence length."""
    n_super, n_m, _, ph = _dims(cfg)
    H, d, L = cfg.n_heads, cfg.d_model, n_super * n_m

    def fill(shape, v=0.0):
        return torch.full(shape, v, dtype=torch.float32, device=device)
    return {"mlstm": {"C": fill((L, batch, H, ph, ph)),
                      "n": fill((L, batch, H, ph)),
                      "m": fill((L, batch, H), NEG)},
            "slstm": {k: fill((n_super, batch, d), NEG if k == "m" else 0.0)
                      for k in "cnmh"}}


def forward_chunk(p: Params, tokens, rt: Runtime, table, cache: Params,
                  pos, valid=None) -> Tuple[torch.Tensor, Params, Any]:
    """Positioned-chunk forward: tokens [B, T] continue each row's
    recurrent state; pos [B] is accepted for a uniform API (the state is
    position-free, every update row-independent); valid [B] masks a
    bucket-padded chunk.  T = 1 is the pooled decode recurrence, a fresh
    state with T = prompt length bulk prefill.  The state is updated in
    place.  Returns (last-valid-token logits [B, V], cache, table)."""
    cfg = rt.cfg
    dev = rt.device
    x = embed(p, torch.as_tensor(tokens, device=dev), rt)
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev)
    ms, ss = cache["mlstm"], cache["slstm"]
    i = 0
    for s, (mlayers, sblock) in enumerate(_super_blocks(p, cfg)):
        for layer_p in mlayers:
            st = (ms["C"][i], ms["n"][i], ms["m"][i])
            y, new = mlstm_block(layer_p, x, rt, state=st, valid=valid)
            for dst, src in zip(st, new):
                dst.copy_(src)
            x = x + y
            i += 1
        st = tuple(ss[k][s] for k in "cnmh")
        x, new = slstm_block(sblock, x, rt, state=st, valid=valid)
        for dst, src in zip(st, new):
            dst.copy_(src)
    x = norm(p["final_norm"], x, rt)
    logits = lm_head(p, last_valid(x, valid), rt)[:, 0]
    return logits, cache, table


def prefill(p: Params, tokens, rt: Runtime, table, cache: Params):
    """Bulk prefill = forward_chunk over the whole prompt."""
    zero = torch.zeros((len(tokens),), dtype=torch.int32, device=rt.device)
    return forward_chunk(p, tokens, rt, table, cache, zero)


def decode_step(p: Params, token, rt: Runtime, table, cache: Params, pos):
    """Pooled decode = forward_chunk at width T = 1.  token: [B]."""
    token = torch.as_tensor(token, device=rt.device)
    return forward_chunk(p, token[:, None], rt, table, cache, pos)


def declare_fold_slots(spec: DeviceFoldSpec, cfg: ModelConfig) -> None:
    spec.declare("app", "loss", "train_step", "count")

"""Plain PyTorch versions of the port's kernels.

The ground truth the CUDA kernels are held against on the card, and what
the wrappers run for a tensor that lies on the CPU.  Each mirrors its
counterpart in the reference `repro/kernels/ref.py`, with one deliberate
difference: a row that sees no column (a decode row with kv_len == 0, a
causal attention row with Sq > Sk whose offset puts it before column 0)
returns ZEROS, as the Pallas kernels do, where the reference oracle's
finite NEG_INF mask gives the mean of v.

The backward passes (`attention_backward`, `rmsnorm_backward`,
`ssd_scan_backward`) compute in f32 and return gradients in the inputs'
dtypes.

The Mamba2 SSD scan has three plain versions: `ssd_naive` (the
step-by-step recurrence) and `ssd_chunked` (the chunked algorithm) as the
reference writes them, and `ssd_scan`, the function the CUDA kernel
computes: `ssd_chunked` with dt·x rounded to x's dtype first, as the
reference's `ops.ssd_scan` rounds it before its Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ------------------------------------------------------------ attention ----
def _scores(q, k, causal, sm_scale, logit_softcap, q_offset):
    """Grouped f32 scores of attention: (qs [B,Hkv,g,Sq,D] = q * scale,
    s [B,Hkv,g,Sq,Sk] after the softcap, tanh(s/c) or None, visibility
    mask [Sq, Sk] or None)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    scale = sm_scale if sm_scale is not None else D ** -0.5
    qs = (q.float() * scale).reshape(B, Hkv, Hq // Hkv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs, k.float())
    th = None
    if logit_softcap > 0:
        th = torch.tanh(s / logit_softcap)
        s = logit_softcap * th
    mask = None
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + q_offset
        mask = torch.arange(Sk, device=q.device)[None, :] <= rows
    return qs, s, th, mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: Optional[float] = None,
              logit_softcap: float = 0.0, q_offset: int = 0,
              return_lse: bool = False):
    """GQA attention.  q: [B, Hq, Sq, D]; k: [B, Hkv, Sk, D]; v:
    [B, Hkv, Sk, Dv] -> o [B, Hq, Sq, Dv].  v narrower than q/k (MLA
    training: D 192, Dv 128) gives the first Dv columns of the reference's
    attention on v zero-padded to D, which are those columns exactly.
    q_offset: absolute position of q[0] (causal: query t sees columns
    <= t + q_offset).  With return_lse=True also returns the f32
    log-sum-exp of each row's scores, lse [B, Hq, Sq] (NEG_INF for a row
    that sees no column; that row's output is zeros)."""
    B, Hq, Sq, _ = q.shape
    _, s, _, mask = _scores(q, k, causal, sm_scale, logit_softcap, q_offset)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    o = (o / torch.where(l == 0.0, 1.0, l)).reshape(B, Hq, Sq, -1).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l))
    return o, lse.reshape(B, Hq, Sq)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       *, causal: bool = True,
                       sm_scale: Optional[float] = None,
                       logit_softcap: float = 0.0, q_offset: int = 0):
    """The FlashAttention-2 backward of `attention` from its saved
    (q, k, v, o, lse), as the reference's custom VJP
    (`repro/kernels/ref.py::_flash_chunked_bwd_impl`) computes it:
    p = exp(s - lse), delta = rowsum(dO * O), dS = p * (dP - delta),
    plus the softcap's chain factor 1 - tanh^2(s/c), which the reference
    gets from autodiff of its softcap path.  Returns (dq, dk, dv) in the
    dtypes of q, k, v; dk, dv sum over the q heads of each kv head.  v,
    o and do may be narrower than q/k (Dv < D): dv is then the first Dv
    columns of the padded-v gradient, and the padding's zero columns of o
    and do add nothing to delta or dP."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    qs, s, th, mask = _scores(q, k, causal, sm_scale, logit_softcap,
                              q_offset)
    shape = (B, Hkv, g, Sq)
    p = torch.exp(s - lse.float().reshape(shape)[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dof = do.float().reshape(shape + (-1,))
    delta = (dof * o.float().reshape(shape + (-1,))).sum(-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    ds = p * (dp - delta)
    if th is not None:
        ds = ds * (1.0 - th * th)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qs)
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: Optional[torch.Tensor] = None,
                     sm_scale: Optional[float] = None,
                     return_residuals: bool = False):
    """Single-token decode attention.

    q: [B, Hq, D]; k, v: [B, Hkv, S, D]; kv_len: [B] valid prefix lengths
    (None = all S valid).  With return_residuals=True also returns
    (m, l): [B, Hq] f32 for split-K combination."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    qf = (q.float() * scale).reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k.float())
    if kv_len is None:
        kv_len = torch.full((B,), S, dtype=torch.int32, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, :]
            < kv_len.to(q.device)[:, None])[:, None, None, :]   # [B,1,1,S]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    o_n = (o / torch.where(l == 0.0, 1.0, l)).reshape(B, Hq, D).to(q.dtype)
    if return_residuals:
        return o_n, (m.reshape(B, Hq), l.reshape(B, Hq))
    return o_n


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    pos: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Positioned-chunk attention (offset-causal against the cache).

    q: [B, Hq, T, D] at per-row offsets pos [B]; k, v: [B, Hkv, S, D] the
    full cache (this chunk's rows already written at [pos, pos+T)).
    Query t of row b attends cache columns <= pos[b] + t."""
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    qf = (q.float() * scale).reshape(B, Hkv, g, T, D)
    s = torch.einsum("bhgtd,bhsd->bhgts", qf, k.float())
    limit = (pos.to(q.device).long()[:, None]
             + torch.arange(T, device=q.device)[None, :])          # [B, T]
    cols = torch.arange(S, device=q.device)
    mask = (cols[None, None, :] <= limit[:, :, None])[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgts,bhsd->bhgtd", p, v.float())
    return (o / l).reshape(B, Hq, T, D).to(q.dtype)


def gather_kv_pages(pages: torch.Tensor, block_table: torch.Tensor
                    ) -> torch.Tensor:
    """Materialize a paged KV arena as per-row dense caches.

    pages: [P, Hkv, page_size, D] (page 0 is the engine's scratch page);
    block_table: [B, NB] page ids, row b's virtual cache being the
    concatenation of its NB pages.  Returns [B, Hkv, NB*page_size, D]."""
    g = pages[block_table.to(pages.device).long()]      # [B, NB, Hkv, ps, D]
    B, NB, Hkv, ps, D = g.shape
    return g.movedim(1, 2).reshape(B, Hkv, NB * ps, D)


def chunk_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, *, block_table: torch.Tensor,
                          pos: torch.Tensor,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Paged positioned-chunk attention: gather the row's pages through
    the block table, then the dense chunk_attention.  q: [B, Hq, T, D];
    k_pages/v_pages: [P, Hkv, page_size, D]; block_table: [B, NB];
    pos: [B].  Columns past pos[b] + t get exactly zero softmax mass, so
    scratch-page content and ungranted pages never leak in."""
    return chunk_attention(q, gather_kv_pages(k_pages, block_table),
                           gather_kv_pages(v_pages, block_table), pos=pos,
                           sm_scale=sm_scale)


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, *,
                           block_table: torch.Tensor,
                           kv_len: Optional[torch.Tensor] = None,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Paged single-token decode (gather pages, dense decode_attention):
    q: [B, Hq, D]; k_pages/v_pages: [P, Hkv, page_size, D]; block_table:
    [B, NB]; kv_len: [B] (None = NB*page_size).  A row with kv_len == 0
    gives zeros, as in decode_attention."""
    return decode_attention(q, gather_kv_pages(k_pages, block_table),
                            gather_kv_pages(v_pages, block_table),
                            kv_len=kv_len, sm_scale=sm_scale)


def _latent_kv(ckv: torch.Tensor, krope: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One latent kv head in the k/v form the reference's mla_attention
    builds: k = [ckv | krope], v = ckv zero-padded to the same width, each
    with a kv head axis: [.., S, r], [.., S, dr] -> [.., 1, S, r + dr]."""
    return (torch.cat([ckv, krope], dim=-1)[:, None],
            F.pad(ckv, (0, krope.shape[-1]))[:, None])


def decode_attention_latent(q: torch.Tensor, ckv: torch.Tensor,
                            krope: torch.Tensor, *,
                            kv_len: Optional[torch.Tensor] = None,
                            sm_scale: Optional[float] = None,
                            return_residuals: bool = False):
    """MLA's latent decode: q [B, Hq, r + dr] against one latent kv head
    whose K rows are [ckv | krope] and V rows ckv (ckv [B, S, r], krope
    [B, S, dr]) -> [B, Hq, r] (+ (m, l) [B, Hq] f32 with
    return_residuals).  As the reference computes it: `decode_attention`
    with v zero-padded to r + dr, the padding's output columns dropped."""
    k, v = _latent_kv(ckv, krope)
    out = decode_attention(q, k, v, kv_len=kv_len, sm_scale=sm_scale,
                           return_residuals=return_residuals)
    r = ckv.shape[-1]
    return (out[0][..., :r], out[1]) if return_residuals else out[..., :r]


def chunk_attention_latent(q: torch.Tensor, ckv: torch.Tensor,
                           krope: torch.Tensor, *, pos: torch.Tensor,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """MLA's latent positioned chunk: q [B, Hq, T, r + dr] at per-row
    offsets pos [B] against ckv [B, S, r], krope [B, S, dr] ->
    [B, Hq, T, r]; `chunk_attention` in the k/v form, as
    `decode_attention_latent`."""
    k, v = _latent_kv(ckv, krope)
    return chunk_attention(q, k, v, pos=pos,
                           sm_scale=sm_scale)[..., :ckv.shape[-1]]


def decode_attention_latent_paged(q: torch.Tensor, ckv_pages: torch.Tensor,
                                  krope_pages: torch.Tensor, *,
                                  block_table: torch.Tensor,
                                  kv_len: Optional[torch.Tensor] = None,
                                  sm_scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """`decode_attention_latent` over two page arenas, ckv_pages
    [P, page_size, r] and krope_pages [P, page_size, dr], through one
    block_table [B, NB] -> [B, Hq, r]."""
    k, v = _latent_kv(ckv_pages, krope_pages)
    return decode_attention_paged(q, k, v, block_table=block_table,
                                  kv_len=kv_len,
                                  sm_scale=sm_scale)[..., :ckv_pages.shape[-1]]


def chunk_attention_latent_paged(q: torch.Tensor, ckv_pages: torch.Tensor,
                                 krope_pages: torch.Tensor, *,
                                 block_table: torch.Tensor, pos: torch.Tensor,
                                 sm_scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """`chunk_attention_latent` over two page arenas through one
    block_table, as `decode_attention_latent_paged` -> [B, Hq, T, r]."""
    k, v = _latent_kv(ckv_pages, krope_pages)
    return chunk_attention_paged(q, k, v, block_table=block_table, pos=pos,
                                 sm_scale=sm_scale)[..., :ckv_pages.shape[-1]]


def combine_decode_partials(o_parts: torch.Tensor, m_parts: torch.Tensor,
                            l_parts: torch.Tensor) -> torch.Tensor:
    """Numerically stable split-K merge of per-shard decode partials.

    o_parts: [K, B, H, D] per-shard normalized outputs; m, l: [K, B, H]."""
    m_star = m_parts.amax(dim=0)
    alpha = torch.exp(m_parts - m_star[None])
    l_star = (alpha * l_parts).sum(dim=0)
    w = (alpha * l_parts) / l_star[None]
    return (o_parts * w[..., None]).sum(dim=0).to(o_parts.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w, reduction in f32; the
    normalized row is rounded to x's dtype before the scale, as in the
    reference oracle."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                     eps: float = 1e-5):
    """Gradient of `rmsnorm` in f32: with r = rsqrt(mean(x^2) + eps),
    g = dy * w and xhat = x * r, dx = r * (g - xhat * mean(g * xhat));
    dw = the sum over rows of dy * round(xhat), the normalized row as the
    forward rounds it to x's dtype.  Returns (dx in x's dtype, dw in w's
    dtype)."""
    D = x.shape[-1]
    xf = x.float().reshape(-1, D)
    dyf = dy.float().reshape(-1, D)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gw = dyf * w.to(x.dtype).float()
    dx = r * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = (dyf * xhat.to(x.dtype).float()).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


def rmsnorm_add(x: torch.Tensor, residual: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused residual add and RMSNorm: s = x + residual in x's dtype,
    returns (rmsnorm(s, w), s), as the reference's `ops.rmsnorm_add`
    computes it on its plain path."""
    s = x + residual.to(x.dtype)
    return rmsnorm(s, w, eps=eps), s


# ----------------------------------------------------------- mamba2 SSD ----
def _wide(x: torch.Tensor) -> torch.dtype:
    """The SSD versions' working dtype: f32, or f64 for f64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def ssd_naive(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential Mamba2 SSD recurrence, step by step (the ground
    truth).  x: [B, L, H, P]; dt: [B, L, H] (softplus'd, >= 0); a: [H]
    (negative); b, c: [B, L, N] (one group); h0: [B, H, N, P] (None =
    zeros).  Computes in f32; returns (y [B, L, H, P] in x's dtype,
    h_final [B, H, N, P] f32)."""
    B, L, H, P = x.shape
    N = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    af = a.float()
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().clone())
    ys = []
    for t in range(L):
        decay = torch.exp(af[None, :] * dtf[:, t])                 # [B, H]
        dbx = torch.einsum("bh,bn,bhp->bhnp", dtf[:, t], bf[:, t], xf[:, t])
        h = decay[..., None, None] * h + dbx
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def _ssd_chunks(dtx: torch.Tensor, ldec: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int, h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD in dtx's dtype (f32, or f64 for f64 inputs) from
    dtx [B, L, H, P] and ldec [B, L, H]: within a chunk a masked
    (C B^T * decay) @ dtx product, across chunks the state recurrence.
    Returns (y, h_final) in dtx's dtype."""
    B, L, H, P = dtx.shape
    N = b.shape[-1]
    if L % chunk:
        raise ValueError(f"L = {L} is not a multiple of chunk = {chunk}")
    nc = L // chunk
    dtx = dtx.reshape(B, nc, chunk, H, P)
    bf = b.to(dtx.dtype).reshape(B, nc, chunk, N)
    cf = c.to(dtx.dtype).reshape(B, nc, chunk, N)
    cum = torch.cumsum(ldec.reshape(B, nc, chunk, H), dim=2)     # inclusive
    # intra-chunk: y[i] = sum_{j<=i} exp(cum[i]-cum[j]) (c_i . b_j) dtx[j];
    # the mask is applied before the exponential (cum[i]-cum[j] > 0 for
    # j > i could overflow)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,nc,T,T,H]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=dtx.device).tril()[None, None, :, :, None]
    m = torch.exp(torch.where(tri, seg, float("-inf")))
    g = torch.einsum("bktn,bksn->bkts", cf, bf)                  # [B,nc,T,T]
    y = torch.einsum("bktsh,bkshp->bkthp", g[..., None] * m, dtx)
    # inter-chunk: the state before each chunk, then its contribution
    decay = torch.exp(cum[:, :, -1])                             # [B,nc,H]
    w = torch.exp(cum[:, :, -1:] - cum)                          # [B,nc,T,H]
    s_in = torch.einsum("bktn,bkthp->bkhnp", bf, w[..., None] * dtx)
    h = (torch.zeros((B, H, N, P), dtype=dtx.dtype, device=dtx.device)
         if h0 is None else h0.to(dtx.dtype))
    h_prev = []
    for k in range(nc):
        h_prev.append(h)
        h = decay[:, k, :, None, None] * h + s_in[:, k]
    h_prev = torch.stack(h_prev, dim=1)                          # [B,nc,H,N,P]
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bktn,bkhnp->bkthp", cf, h_prev)
    return y.reshape(B, L, H, P), h


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD (Mamba2's state-space dual algorithm), computing in
    f32: dtx = dt·x and ldec = a·dt unrounded.  Shapes as `ssd_naive`;
    L a multiple of `chunk`.  Returns (y in x's dtype, h_final f32; f64
    for f64 inputs)."""
    w = _wide(x)
    dtf = dt.to(w)
    y, h = _ssd_chunks(dtf[..., None] * x.to(w),
                       a.to(w)[None, None, :] * dtf, b, c, chunk, h0)
    return y.to(x.dtype), h


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function of the SSD kernel: `ssd_chunked` with dtx = dt·x
    formed in f32 and rounded to x's dtype (the reference's `ops.ssd_scan`
    rounds it so before its Pallas kernel), ldec = a·dt in f32.  In f32
    it equals `ssd_chunked`."""
    w = _wide(x)
    dtf = dt.to(w)
    dtx = (dtf[..., None] * x.to(w)).to(x.dtype).to(w)
    y, h = _ssd_chunks(dtx, a.to(w)[None, None, :] * dtf, b, c, chunk, h0)
    return y.to(x.dtype), h


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: torch.Tensor,
                      dh_final: Optional[torch.Tensor], *, chunk: int = 128):
    """Gradient of `ssd_scan` in f32, as the chunked reverse recurrence
    the backward kernel follows.  The rounding of dtx = round(dt·x) passes
    the gradient as the identity, as autograd of `ssd_scan` does; in f32
    this is the gradient of `ssd_chunked`.

    Per chunk, with cum the inclusive cumsum of ldec = a·dt, S = (C B^T) ⊙
    exp(cum_i - cum_j) (j <= i), w_j = exp(cum_last - cum_j), decay =
    exp(cum_last) and h the state before the chunk:
      y = S dtx + exp(cum) ⊙ (C h),  h' = decay h + B^T (w ⊙ dtx).
    First the states before every chunk (the forward recurrence), then a
    reverse pass carrying dh, the gradient of the state after a chunk
    (dh_final, or 0, after the last):
      dh_before = decay dh + C^T (exp(cum) ⊙ dy).
    With both known, every chunk's gradients are local: d(dtx) = S^T dy +
    w ⊙ (B dh); dS = dy dtx^T, so dC and dB take (dS ⊙ exp(..)) summed
    over heads and the C h / B^T (w dtx) terms; dcum_i collects the row
    sums less the column sums of dS ⊙ S, the C h term, the w and decay
    terms; d(ldec) is the reverse cumsum of dcum.  Then dx = d(dtx)·dt,
    ddt = Σ_p d(dtx)·x + a·d(ldec), da = Σ_{b,t} d(ldec)·dt.

    Shapes as `ssd_scan`; dy like x; dh_final [B, H, N, P] or None.
    Returns (dx, ddt, da, db, dc, dh0) in the dtypes of (x, dt, a, b, c)
    and f32 for dh0 (None when h0 is None); f64 inputs compute in f64."""
    B, L, H, P = x.shape
    N = b.shape[-1]
    if L % chunk:
        raise ValueError(f"L = {L} is not a multiple of chunk = {chunk}")
    nc, T = L // chunk, chunk
    dev, wd = x.device, _wide(x)
    dtf, af = dt.to(wd), a.to(wd)
    xf = x.to(wd).reshape(B, nc, T, H, P)
    dtx = (dtf[..., None] * x.to(wd)).to(x.dtype).to(wd) \
        .reshape(B, nc, T, H, P)
    bf = b.to(wd).reshape(B, nc, T, N)
    cf = c.to(wd).reshape(B, nc, T, N)
    dyf = dy.to(wd).reshape(B, nc, T, H, P)
    cum = torch.cumsum((af[None, None, :] * dtf).reshape(B, nc, T, H), dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,nc,T,T,H]
    tri = torch.ones((T, T), dtype=torch.bool,
                     device=dev).tril()[None, None, :, :, None]
    m = torch.exp(torch.where(tri, seg, float("-inf")))
    s = torch.einsum("bktn,bksn->bkts", cf, bf)[..., None] * m
    ecum = torch.exp(cum)
    decay = torch.exp(cum[:, :, -1])                             # [B,nc,H]
    w = torch.exp(cum[:, :, -1:] - cum)                          # [B,nc,T,H]

    # the states before each chunk, then dh after each chunk (reverse)
    h = (torch.zeros((B, H, N, P), dtype=wd, device=dev)
         if h0 is None else h0.to(wd))
    h_prev = []
    for k in range(nc):
        h_prev.append(h)
        h = decay[:, k, :, None, None] * h + torch.einsum(
            "btn,bthp->bhnp", bf[:, k], w[:, k, :, :, None] * dtx[:, k])
    h_prev = torch.stack(h_prev, dim=1)                          # [B,nc,H,N,P]
    dh = (torch.zeros((B, H, N, P), dtype=wd, device=dev)
          if dh_final is None else dh_final.to(wd))
    dh_after = [None] * nc
    for k in reversed(range(nc)):
        dh_after[k] = dh
        dh = decay[:, k, :, None, None] * dh + torch.einsum(
            "btn,bthp->bhnp", cf[:, k], ecum[:, k, :, :, None] * dyf[:, k])
    dh_after = torch.stack(dh_after, dim=1)                      # [B,nc,H,N,P]

    # chunk-local gradients
    bdh = torch.einsum("bksn,bkhnp->bkshp", bf, dh_after)        # B dh
    ddtx = torch.einsum("bktsh,bkthp->bkshp", s, dyf) + w[..., None] * bdh
    ds = torch.where(tri, torch.einsum("bkthp,bkshp->bktsh", dyf, dtx), 0.0)
    dg = (ds * m).sum(-1)                                        # [B,nc,T,T]
    q = ds * s
    ch = torch.einsum("bktn,bkhnp->bkthp", cf, h_prev)           # C h
    dxh = torch.einsum("bkthp,bkhnp->bkthn", ecum[..., None] * dyf, h_prev)
    dc = torch.einsum("bkts,bksn->bktn", dg, bf) + dxh.sum(3)
    dtxdh = torch.einsum("bkshp,bkhnp->bkshn", dtx, dh_after)    # dtx dh^T
    db = torch.einsum("bkts,bktn->bksn", dg, cf) \
        + (w[..., None] * dtxdh).sum(3)
    wdw = w * (dtx * bdh).sum(-1)                                # w ⊙ dw
    dcum = q.sum(3) - q.sum(2) + ecum * (dyf * ch).sum(-1) - wdw
    dcum[:, :, -1] += wdw.sum(2) + decay * (dh_after * h_prev).sum((-2, -1))
    dldec = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,))
    ddtx, dldec = ddtx.reshape(B, L, H, P), dldec.reshape(B, L, H)
    dx = ddtx * dtf[..., None]
    ddt = (ddtx * xf.reshape(B, L, H, P)).sum(-1) + af * dldec
    da = (dldec * dtf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), da.to(a.dtype),
            db.reshape(B, L, N).to(b.dtype), dc.reshape(B, L, N).to(c.dtype),
            None if h0 is None else dh)

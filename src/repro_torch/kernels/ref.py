"""Plain PyTorch versions of the serving path's kernels.

The ground truth the CUDA kernels are held against on the card, and what
the wrappers run for a tensor that lies on the CPU.  Each mirrors its
counterpart in the reference `repro/kernels/ref.py`, with one deliberate
difference: a decode row with kv_len == 0 returns ZEROS (with m = NEG_INF,
l = 0), as the Pallas decode kernel does, where the reference oracle's
finite NEG_INF mask gives the mean of v.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


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

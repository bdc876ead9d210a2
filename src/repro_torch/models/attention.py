"""GQA attention, paged layout (counterpart of the paged branch of
``repro.models.attention.gqa_apply``).

K/V live in a shared physical page pool addressed through a per-sequence
block table.  Each call writes its new tokens' K/V into their (page, offset)
cells with one scatter per pool — in place: the pool tensors are updated,
not copied — then attends with the paged kernels: ``paged_attention`` for
1-token chunks, ``paged_prefill`` for wider ones.  Right-padded positions
(``write_lens``) and positions past the block table write to the null page
0, which no row ever reads unmasked.  When the cache carries scale pools
(int8 KV) each token's K and V are quantized per kv head on the way in and
their scales land in the same (page, offset) cells of the scale pools.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as L
from repro_torch.serving import kv_quant as KQ


class GQA(nn.Module):
    def __init__(self, wq: L.Linear, wk: L.Linear, wv: L.Linear,
                 wo: L.Linear, q_norm: torch.Tensor | None = None,
                 k_norm: torch.Tensor | None = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.register_buffer("q_norm", q_norm)
        self.register_buffer("k_norm", k_norm)

    @classmethod
    def init(cls, gen, cfg: ModelConfig, **lin) -> "GQA":
        d, hd = cfg.d_model, cfg.head_dim
        dev, dtype = lin["device"], lin["dtype"]
        norms = {}
        if cfg.qk_norm:
            norms = {"q_norm": torch.ones((hd,), dtype=dtype, device=dev),
                     "k_norm": torch.ones((hd,), dtype=dtype, device=dev)}
        return cls(
            L.linear_init(gen, d, cfg.num_heads * hd, bias=cfg.qkv_bias, **lin),
            L.linear_init(gen, d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias,
                          **lin),
            L.linear_init(gen, d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias,
                          **lin),
            L.linear_init(gen, cfg.num_heads * hd, d, **lin), **norms)

    def forward(self, x: torch.Tensor, *, cfg: ModelConfig,
                positions: torch.Tensor,
                cache: dict, seq_lens: torch.Tensor,
                block_tables: torch.Tensor,
                write_lens: torch.Tensor | None = None) -> torch.Tensor:
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = L.linear(self.wq, x).reshape(b, s, cfg.num_heads, hd)
        k = L.linear(self.wk, x).reshape(b, s, cfg.num_kv_heads, hd)
        v = L.linear(self.wv, x).reshape(b, s, cfg.num_kv_heads, hd)
        if cfg.qk_norm:
            q = L.rms_head_norm(self.q_norm, q, cfg.norm_eps)
            k = L.rms_head_norm(self.k_norm, k, cfg.norm_eps)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

        kp, vp = cache["k_pages"], cache["v_pages"]
        ksc, vsc = cache.get("k_scales"), cache.get("v_scales")
        ps, maxp = kp.shape[1], block_tables.shape[1]
        ar = torch.arange(s, device=x.device)
        tpos = seq_lens[:, None].to(torch.int64) + ar[None, :]     # (B, S)
        lpage = tpos // ps
        pages = torch.gather(block_tables, 1, lpage.clamp(max=maxp - 1))
        # overrunning positions and right-padding go to the null page
        pages = torch.where(lpage < maxp, pages, 0)
        if write_lens is not None:
            pages = torch.where(ar[None, :] < write_lens[:, None], pages, 0)
        pages, offs = pages.long(), tpos % ps
        if ksc is not None:                  # quantize-on-write, per token
            k, kss = KQ.quantize(k, scale_dtype=ksc.dtype)
            v, vss = KQ.quantize(v, scale_dtype=vsc.dtype)
            ksc[pages, offs] = kss
            vsc[pages, offs] = vss
        kp[pages, offs] = k.to(kp.dtype)
        vp[pages, offs] = v.to(vp.dtype)
        scales = dict(k_scales=ksc, v_scales=vsc)
        if s == 1:
            out = PA.paged_attention(q[:, 0], kp, vp, block_tables,
                                     seq_lens + 1, **scales)[:, None]
        else:
            wl = write_lens if write_lens is not None else torch.full_like(
                seq_lens, s)
            out = PA.paged_prefill(q, kp, vp, block_tables, seq_lens,
                                   seq_lens + wl, **scales)
        return L.linear(self.wo, out.reshape(b, s, cfg.num_heads * hd))

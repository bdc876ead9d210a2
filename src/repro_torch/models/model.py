"""Top-level language model (counterpart of ``repro.models.model.LM``):
embeddings -> blocks -> final norm -> tied logits, dense full-attention
stacks on the paged KV layout.  ``repro``'s ``lax.scan`` over stacked
layers is a loop over an ``nn.ModuleList`` here.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.blocks import Block, block_paged_cache_init

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, embedding: torch.Tensor,
                 layers: list[Block], final_norm: torch.Tensor):
        super().__init__()
        if cfg.family != "dense" or cfg.attn_type != "gqa" \
                or not cfg.tie_embeddings:
            raise NotImplementedError(
                f"config {cfg.name!r}: this slice ports dense GQA stacks "
                f"with tied embeddings; other families come later")
        self.cfg = cfg
        self.register_buffer("embedding", embedding)
        self.layers = nn.ModuleList(layers)
        self.register_buffer("final_norm", final_norm)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.dtype]

    # ------------------------------------------------------------------ init
    @classmethod
    def init(cls, cfg: ModelConfig, *, seed: int = 0, device=None,
             quant_group: int | None = None,
             scale_dtype: torch.dtype | None = None) -> "LM":
        """Random weights from a seeded ``torch.Generator`` with
        ``repro``'s init scales.  With ``quant_group`` every projection is
        quantized (RTN, AutoGPTQ layout) as soon as it is made, one matrix
        at a time, with scales in ``scale_dtype`` (default: the model
        dtype)."""
        dev = resolve_device(device)
        dtype = DTYPES[cfg.dtype]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        lin = dict(device=dev, dtype=dtype, quant_group=quant_group,
                   scale_dtype=scale_dtype)
        embedding = L.normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                             dev).to(dtype)
        layers = [Block.init(gen, cfg, **lin) for _ in range(cfg.num_layers)]
        final_norm = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        return cls(cfg, embedding, layers, final_norm)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype: torch.dtype = torch.float32,
                         kv_quant=None) -> dict:
        """Page pools of every layer (int8 with scale pools when
        ``kv_quant`` stores int8; see ``block_paged_cache_init``)."""
        return block_paged_cache_init(self.cfg, self.cfg.num_layers,
                                      num_pages, page_size, dtype=dtype,
                                      device=self.device, kv_quant=kv_quant)

    # --------------------------------------------------------------- forward
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return L.embed_logits(self.embedding, x)

    def forward_chunks(self, tokens: torch.Tensor, chunk_lens: torch.Tensor,
                       cache: dict, seq_lens: torch.Tensor, *,
                       block_tables: torch.Tensor,
                       logit_index: torch.Tensor | None = None):
        """Unified serving forward: row b is the span ``[seq_lens[b],
        seq_lens[b] + chunk_lens[b])`` of its sequence, right-padded to C.

        tokens (B, C) int; chunk_lens (B,) int32 real tokens per row (padded
        positions write to the null page); seq_lens (B,) int32.  Writes the
        chunk's K/V into ``cache`` in place and returns (logits, cache); the
        caller advances seq_lens.  Logits are float32 (B, C, V), or (B, V)
        at the one position ``logit_index[b]`` of each row when it is given
        — all a serving step reads, and C times less head work."""
        cfg = self.cfg
        x = L.embed_lookup(self.embedding, tokens, self.dtype)
        s = x.shape[1]
        positions = seq_lens[:, None] + torch.arange(
            s, dtype=torch.int32, device=x.device)[None, :]
        for i, layer in enumerate(self.layers):
            x = layer(x, cfg=cfg, positions=positions,
                      cache={name: pool[i] for name, pool in cache.items()},
                      seq_lens=seq_lens, block_tables=block_tables,
                      write_lens=chunk_lens)
        if logit_index is not None:
            x = x[torch.arange(x.shape[0], device=x.device),
                  logit_index.long()]
        x = L.apply_norm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x), cache

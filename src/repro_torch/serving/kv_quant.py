"""KV-cache storage config and byte accounting (the part of
``repro.serving.kv_quant`` this slice serves).  Only the float passthrough
modes are served; int8 pools and their kernels come in a later slice."""
from __future__ import annotations

import dataclasses

import torch

_KV_DTYPES = {"fp32": torch.float32, "float32": torch.float32,
              "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
              "int8": torch.int8}
_CANONICAL = {"float32": "fp32", "bfloat16": "bf16"}


@dataclasses.dataclass(frozen=True)
class KVQuantConfig:
    """What the KV cache stores: ``"fp32"``/``"bf16"`` passthrough (the same
    as setting the cache dtype) or ``"int8"`` (not ported yet)."""
    dtype: str = "int8"

    def __post_init__(self):
        if self.dtype not in _KV_DTYPES:
            raise ValueError(f"unknown KV-quant dtype {self.dtype!r}")
        object.__setattr__(self, "dtype",
                           _CANONICAL.get(self.dtype, self.dtype))

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _KV_DTYPES[self.dtype]


def default_num_pages(batch_slots: int, max_len: int, page_size: int) -> int:
    """Capacity-equivalent pool: every row's worst case at page grain."""
    return batch_slots * -(-max_len // page_size)


def page_bytes(n_layers: int, kv_heads: int, head_dim: int, page_size: int,
               *, dtype: torch.dtype = torch.float32) -> int:
    """Bytes of one allocatable page across all layers, K and V."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return n_layers * 2 * page_size * kv_heads * head_dim * itemsize


def num_pages_for_budget(budget_bytes: int, n_layers: int, kv_heads: int,
                         head_dim: int, page_size: int, *,
                         dtype: torch.dtype = torch.float32) -> int:
    """Allocatable pages a byte budget buys (the null page excluded)."""
    per_page = page_bytes(n_layers, kv_heads, head_dim, page_size,
                          dtype=dtype)
    pages = int(budget_bytes) // per_page
    if pages <= 0:
        raise ValueError(f"page-pool byte budget {budget_bytes} buys zero "
                         f"pages ({per_page} bytes/page)")
    return pages

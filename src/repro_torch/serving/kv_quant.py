"""Quantized KV-cache storage (counterpart of ``repro.serving.kv_quant``).

* ``KVQuantConfig`` — what the cache stores: ``fp32``/``bf16`` passthrough
  or ``int8`` payloads with symmetric scales at ``token`` (one scale per
  written token per kv head) or ``page`` (one per physical page per kv
  head) granularity.
* ``quantize`` / ``dequantize`` — the symmetric round-to-nearest transform
  of the model's cache write and of the kernels' plain versions.
* Byte accounting — ``page_bytes`` / ``num_pages_for_budget``: with
  ``EngineConfig.page_pool_bytes`` the page pool is derived from a byte
  budget, so int8 KV buys about twice the pages of bf16.

Scale pools are parallel to the ``(P + 1, page_size, Hkv, D)`` payload
pools: ``(P + 1, page_size, Hkv)`` per token, ``(P + 1, Hkv)`` per page.
"""
from __future__ import annotations

import dataclasses

import torch

QMAX = 127.0                 # symmetric int8 range [-127, 127]
_SCALE_FLOOR = 1e-8          # an all-zero vector quantizes to zeros, not NaN

_KV_DTYPES = {"fp32": torch.float32, "float32": torch.float32,
              "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
              "int8": torch.int8}
_CANONICAL = {"float32": "fp32", "bfloat16": "bf16"}
_SCALE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRANULARITIES = ("token", "page")


@dataclasses.dataclass(frozen=True)
class KVQuantConfig:
    """How the serving KV cache stores keys and values.

    ``dtype``: ``"fp32"``/``"bf16"`` are passthrough (the same as setting
    the cache dtype); ``"int8"`` stores symmetric 8-bit payloads plus a
    parallel scale pool.  ``granularity`` picks the scale resolution
    (``"token"`` or ``"page"``); ``scale_dtype`` the scale pool's dtype.
    """
    dtype: str = "int8"
    granularity: str = "token"
    scale_dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in _KV_DTYPES:
            raise ValueError(
                f"unknown KV-quant dtype {self.dtype!r}; expected one of "
                f"{sorted(set(_CANONICAL) | set(_CANONICAL.values()) | {'int8'})}")
        object.__setattr__(self, "dtype",
                           _CANONICAL.get(self.dtype, self.dtype))
        if self.granularity not in GRANULARITIES:
            raise ValueError(
                f"unknown KV-quant granularity {self.granularity!r}; "
                f"expected one of {GRANULARITIES}")
        if self.scale_dtype not in _SCALE_DTYPES:
            raise ValueError(
                f"KV-quant scale_dtype must be a float dtype "
                f"{sorted(_SCALE_DTYPES)}, got {self.scale_dtype!r}")

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def torch_dtype(self) -> torch.dtype:
        """Payload storage dtype (int8 when quantized)."""
        return _KV_DTYPES[self.dtype]

    @property
    def scale_torch_dtype(self) -> torch.dtype:
        return _SCALE_DTYPES[self.scale_dtype]


# ------------------------------------------------------------- the transform
def quantize(x: torch.Tensor, *, axes=(-1,),
             scale_dtype: torch.dtype = torch.float32):
    """Symmetric int8 quantization over ``axes``.

    Returns ``(q, scales)``: ``q`` is int8 with ``x``'s shape; ``scales``
    has ``axes`` removed.  Per-token-per-head KV uses ``axes=(-1,)``;
    per-page ``axes=(position, D)``.  The fp32 scale is ``amax`` times the
    float32 reciprocal of 127 — what XLA compiles ``amax / 127`` into inside
    ``repro``'s jitted engine step — so scales and payloads are
    bit-identical to ``repro``'s.  Rounding is half to even, as
    ``jnp.round``.
    """
    axes = tuple(a % x.ndim for a in axes)
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp(amax, min=_SCALE_FLOOR) * (1.0 / QMAX)
    q = torch.clamp(torch.round(xf / scale), -QMAX, QMAX).to(torch.int8)
    scales = scale
    for a in sorted(axes, reverse=True):
        scales = scales.squeeze(a)
    return q, scales.to(scale_dtype)


def dequantize(q: torch.Tensor, scales: torch.Tensor, *,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize``; granularity is inferred from the rank gap.

    ``q.ndim - scales.ndim == 1`` — per-token ``(..., Hkv)`` scales over
    ``(..., Hkv, D)`` payloads; ``== 2`` — per-page ``(..., Hkv)`` scales
    over ``(..., page_size, Hkv, D)`` payloads.
    """
    gap = q.ndim - scales.ndim
    if gap == 1:                       # token: broadcast over D
        s = scales[..., None]
    elif gap == 2:                     # page: broadcast over (position, D)
        s = scales[..., None, :, None]
    else:
        raise ValueError(
            f"scale rank {scales.ndim} does not match payload rank {q.ndim} "
            f"at token (gap 1) or page (gap 2) granularity")
    return (q.to(torch.float32) * s.to(torch.float32)).to(dtype)


def paged_scale_shape(num_pages: int, page_size: int, kv_heads: int,
                      granularity: str) -> tuple[int, ...]:
    """Per-layer scale-pool shape parallel to a ``(num_pages + 1, page_size,
    Hkv, D)`` payload pool (null page included)."""
    if granularity == "token":
        return (num_pages + 1, page_size, kv_heads)
    if granularity == "page":
        return (num_pages + 1, kv_heads)
    raise ValueError(f"unknown granularity {granularity!r}")


# ------------------------------------------------------------ byte accounting
def default_num_pages(batch_slots: int, max_len: int, page_size: int) -> int:
    """Capacity-equivalent pool: every row's worst case at page grain."""
    return batch_slots * -(-max_len // page_size)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def page_bytes(n_layers: int, kv_heads: int, head_dim: int, page_size: int,
               *, dtype: torch.dtype = torch.float32,
               kv_quant: KVQuantConfig | None = None) -> int:
    """Bytes of one allocatable page across all layers, K and V pools,
    scale pools included."""
    if kv_quant is not None:
        dtype = kv_quant.torch_dtype
    payload = (n_layers * 2 * page_size * kv_heads * head_dim
               * _itemsize(dtype))
    if kv_quant is None or not kv_quant.quantized:
        return payload
    per_page = kv_heads if kv_quant.granularity == "page" \
        else page_size * kv_heads
    return payload + (n_layers * 2 * per_page
                      * _itemsize(kv_quant.scale_torch_dtype))


def num_pages_for_budget(budget_bytes: int, n_layers: int, kv_heads: int,
                         head_dim: int, page_size: int, *,
                         dtype: torch.dtype = torch.float32,
                         kv_quant: KVQuantConfig | None = None) -> int:
    """Allocatable pages a byte budget buys (the null page excluded)."""
    per_page = page_bytes(n_layers, kv_heads, head_dim, page_size,
                          dtype=dtype, kv_quant=kv_quant)
    pages = int(budget_bytes) // per_page
    if pages <= 0:
        raise ValueError(
            f"page-pool byte budget {budget_bytes} buys zero pages "
            f"({per_page} bytes/page at page_size={page_size})")
    return pages

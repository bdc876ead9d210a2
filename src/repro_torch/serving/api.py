"""Public serving API types (counterpart of ``repro.serving.api``):
``EngineConfig``, the request lifecycle, and the records the engine
returns.

``EngineConfig`` keeps ``repro``'s field names.  The fields of options
this slice does not serve yet raise ``NotImplementedError`` naming the
slice that will add them, instead of being ignored.
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from repro_torch.models.layers import DEFAULT_KERNELS, KernelConfig
from repro_torch.serving.kv_quant import KVQuantConfig

_CACHE_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
                 "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


class RequestState(str, enum.Enum):
    QUEUED = "queued"        # submitted, waiting for page admission
    PREFILL = "prefill"      # admitted; prompt KV being written
    RUNNING = "running"      # decoding, first token already produced
    FINISHED = "finished"    # stop token / eos / length
    ABORTED = "aborted"      # cancelled via Engine.abort()


class FinishReason(str, enum.Enum):
    STOP = "stop"
    LENGTH = "length"
    ABORT = "abort"


def _not_ported(field: str, slice_name: str):
    raise NotImplementedError(
        f"EngineConfig.{field}: not served by this port yet — it comes with "
        f"the {slice_name} slice")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine construction config (paged layout, fp or int8 KV, plain
    decode)."""
    batch_slots: int = 8
    max_len: int = 512
    kernels: KernelConfig = DEFAULT_KERNELS
    eos_id: int = 1
    cache: str = "paged"
    page_size: int = 16
    num_pages: int | None = None      # None -> batch_slots * ceil(max_len/ps)
    cache_dtype: object = None        # None -> float32 (repro's default)
    seed: int = 0                     # torch.Generator of sampled rows
    # KVQuantConfig or its dtype string: "fp32"/"bf16" passthrough (folded
    # into cache_dtype) or "int8" pools with per-token scale pools
    kv_quant: object = None
    page_pool_bytes: int | None = None
    clock: object = None              # None -> the real SystemClock
    # token budget of one fused step (None = whole remaining prompts)
    max_step_tokens: int | None = None
    # ---- options of later slices: must stay at these values ----
    max_queued: int | None = None
    default_queue_timeout_s: float | None = None
    preemption: bool = False
    faults: object = None
    metrics: bool = False
    tracer: object = None
    speculation: object = None
    prefix_cache_path: str | None = None
    mesh_shape: tuple | None = None

    def __post_init__(self):
        if self.batch_slots <= 0:
            raise ValueError(f"batch_slots must be > 0, got {self.batch_slots}")
        if self.max_len <= 0:
            raise ValueError(f"max_len must be > 0, got {self.max_len}")
        if self.page_size <= 0:
            raise ValueError(f"page_size must be > 0, got {self.page_size}")
        if self.num_pages is not None and self.num_pages <= 0:
            raise ValueError(f"num_pages must be > 0, got {self.num_pages}")
        if self.max_step_tokens is not None and self.max_step_tokens <= 0:
            raise ValueError(f"max_step_tokens must be > 0, got "
                             f"{self.max_step_tokens}")
        layout = getattr(self.cache, "value", self.cache)
        if layout == "slot":
            _not_ported("cache='slot'", "slot-layout")
        if layout != "paged":
            raise ValueError(f"unknown cache layout {self.cache!r}")
        kvq = self.kv_quant
        if isinstance(kvq, str):
            # shorthand; KVQuantConfig rejects unknown dtype strings
            kvq = KVQuantConfig(dtype=kvq)
        if kvq is not None:
            if not isinstance(kvq, KVQuantConfig):
                raise ValueError(f"kv_quant must be a KVQuantConfig or a "
                                 f"dtype string, got {kvq!r}")
            if kvq.quantized:
                if self.cache_dtype is not None:
                    raise ValueError(
                        f"kv_quant='int8' stores int8 payloads — "
                        f"cache_dtype={self.cache_dtype!r} would be ignored; "
                        f"pass one or the other")
                if kvq.granularity != "token":
                    raise ValueError(
                        "the engine's fused write path uses per-token "
                        "scales; per-page granularity is served by the "
                        "PagedCache data-path API only")
                object.__setattr__(self, "kv_quant", kvq)
            else:
                # fp passthrough is just another way to spell cache_dtype
                dtype = kvq.torch_dtype
                if self.cache_dtype is not None and self._dtype() != dtype:
                    raise ValueError(
                        f"kv_quant passthrough dtype {kvq.dtype!r} "
                        f"conflicts with cache_dtype={self.cache_dtype!r}")
                object.__setattr__(self, "cache_dtype", dtype)
                object.__setattr__(self, "kv_quant", None)
        if self.cache_dtype is not None:
            object.__setattr__(self, "cache_dtype", self._dtype())
        if self.page_pool_bytes is not None:
            if self.page_pool_bytes <= 0:
                raise ValueError(f"page_pool_bytes must be > 0, got "
                                 f"{self.page_pool_bytes}")
            if self.num_pages is not None:
                raise ValueError("pass either num_pages or page_pool_bytes, "
                                 "not both")
        for field, slice_name in (
                ("max_queued", "overload (bounded admission)"),
                ("default_queue_timeout_s", "overload (deadline shedding)"),
                ("faults", "fault-injection"),
                ("tracer", "observability (tracing)"),
                ("speculation", "speculative-decoding"),
                ("prefix_cache_path", "prefix-persistence")):
            if getattr(self, field) is not None:
                _not_ported(field, slice_name)
        if self.preemption:
            _not_ported("preemption", "overload (preemption/offload)")
        if self.metrics:
            _not_ported("metrics", "observability (metrics exposition)")
        if self.mesh_shape is not None and any(d != 1
                                               for d in self.mesh_shape):
            _not_ported("mesh_shape", "tensor-parallel")

    def _dtype(self) -> torch.dtype:
        dt = self.cache_dtype
        if isinstance(dt, torch.dtype):
            if dt not in (torch.float32, torch.bfloat16):
                raise ValueError(f"cache_dtype {dt} is not served")
            return dt
        if dt not in _CACHE_DTYPES:
            raise ValueError(f"unknown cache_dtype {dt!r}")
        return _CACHE_DTYPES[dt]


@dataclasses.dataclass
class RequestOutput:
    """A completed or aborted request with request-level latency metrics."""
    rid: int
    prompt_len: int
    output: list[int]
    arrival: float
    t_first_token: float
    t_done: float
    finish_reason: FinishReason | None = None

    @property
    def state(self) -> RequestState:
        return (RequestState.ABORTED
                if self.finish_reason is FinishReason.ABORT
                else RequestState.FINISHED)

    @property
    def ttft(self) -> float:
        if not self.t_first_token:
            return 0.0
        return self.t_first_token - self.arrival

    @property
    def tpot(self) -> float:
        n = len(self.output)
        if n <= 1 or not self.t_first_token:
            return 0.0
        return (self.t_done - self.t_first_token) / (n - 1)

    @property
    def latency(self) -> float:
        return self.t_done - self.arrival


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One token of one request, yielded by ``Engine.stream()``; terminal
    events carry the ``RequestOutput``."""
    rid: int
    token: int | None
    index: int
    finish_reason: FinishReason | None = None
    output: RequestOutput | None = None

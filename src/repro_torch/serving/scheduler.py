"""Continuous-batching scheduler (counterpart of
``repro.serving.scheduler``): priority-then-FCFS admission, per-request
lifecycle, and the token-budget chunk plan of one fused step."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

from repro_torch.serving.api import RequestState
from repro_torch.serving.sampler import SamplingParams


@dataclasses.dataclass
class Request:
    rid: int
    tokens: list[int]
    max_new_tokens: int = 32
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival: float = 0.0
    stop_token_ids: tuple[int, ...] = ()
    ignore_eos: bool = False
    state: RequestState = RequestState.QUEUED
    priority: int = 0                    # higher = admitted first
    order: int | None = None             # submission order


@dataclasses.dataclass
class Active:
    req: Request
    slot: int
    output: list[int] = dataclasses.field(default_factory=list)
    t_first_token: float = 0.0
    t_admit: float = 0.0
    # the prompt streams into the cache as chunks of the fused step;
    # ``prefill_ctx[prefill_pos:prefill_end]`` is what remains
    prefill_ctx: list[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0
    prefill_end: int = 0

    @property
    def pending_prefill(self) -> bool:
        return self.prefill_pos < self.prefill_end


PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_len(n: int) -> int:
    """Smallest prefill bucket holding ``n`` tokens; multiples of 4096 past
    the table; 0 for ``n <= 0``."""
    if n <= 0:
        return 0
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return -(-n // 4096) * 4096


class Scheduler:
    """Order + admission policy; the engine asks it what to do each step."""

    def __init__(self):
        self.waiting: list[Request] = []
        self.active: dict[int, Active] = {}
        self._order = itertools.count()

    def submit(self, req: Request):
        req.state = RequestState.QUEUED
        if req.order is None:
            req.order = next(self._order)
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (-r.priority, r.order))

    def admit(self, reserve: Callable[[Request], bool]) -> list[Request]:
        """Admit from the head of the queue while ``reserve`` (which commits
        the request's resources) succeeds; the first failure stops
        admission, so exhaustion defers rather than reorders."""
        out = []
        while self.waiting and reserve(self.waiting[0]):
            out.append(self.waiting.pop(0))
        for req in out:
            req.state = RequestState.PREFILL
        return out

    def activate(self, req: Request, slot: int) -> Active:
        a = Active(req=req, slot=slot)
        self.active[slot] = a
        return a

    def retire(self, slot: int) -> Active:
        return self.active.pop(slot)

    def cancel(self, rid: int) -> Optional[Request]:
        """Remove a still-queued request."""
        for i, req in enumerate(self.waiting):
            if req.rid == rid:
                del self.waiting[i]
                return req
        return None

    def find_active(self, rid: int) -> Optional[tuple[int, Active]]:
        for row, a in self.active.items():
            if a.req.rid == rid:
                return row, a
        return None

    def plan_chunks(self, budget: Optional[int], *,
                    reserve: int = 1) -> dict[int, int]:
        """Token-budget packing of one fused step: every decoding row claims
        ``reserve`` tokens; the rest of the budget is dealt to mid-prefill
        rows as prompt chunks in (priority desc, order asc) sequence, and
        the first row the budget cannot feed stops the deal.  ``budget``
        None gives each pending row its whole remaining prompt.  Returns
        {row: chunk_len} for the prefill rows of this step."""
        pending = [(row, a) for row, a in self.active.items()
                   if a.pending_prefill]
        pending.sort(key=lambda e: (-e[1].req.priority, e[1].req.order))
        n_decode = len(self.active) - len(pending)
        remaining = (None if budget is None
                     else max(0, budget - n_decode * reserve))
        plan: dict[int, int] = {}
        for row, a in pending:
            need = a.prefill_end - a.prefill_pos
            take = need if remaining is None else min(need, remaining)
            if take <= 0:
                break
            plan[row] = take
            if remaining is not None:
                remaining -= take
        return plan

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.active

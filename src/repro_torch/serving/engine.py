"""Serving engine, paged layout (counterpart of
``repro.serving.engine.Engine``): continuous batching through one
token-budgeted fused step per iteration.

* ``Engine(model, EngineConfig(...))``; ``submit`` / ``step`` / ``run`` /
  ``generate`` / ``stream`` / ``abort``.
* Admission only *reserves* the request's whole prompt + decode page
  footprint (minus hashed-prefix hits) and a block-table row; a request
  whose prompt shares a full page with a prompt still prefilling waits one
  round so it can share that page once it is written (``_prefix_pending``).
* Every step is one call of ``_fused_step``: each row is a
  ``(seq_lens[row], chunk_len)`` span of its sequence — a decode row is a
  1-token chunk, a prefill row a chunk dealt by ``Scheduler.plan_chunks``
  under ``max_step_tokens`` — right-padded to a bucketed width
  (``_step_width``).  With 8 rows a pure-decode step runs the GEMV lane
  and the decode attention kernel; a wider step runs the GEMM lane and the
  chunked prefill kernel.
* The step's only device->host copy is the packed ``(B, 2)`` int32 result
  ``[n_emitted | token]``.

The KV page pools are updated in place by the model; ``seq_lens`` and the
block table are device tensors owned by ``PagedCache``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.model import LM
from repro_torch.serving import clock as CLK
from repro_torch.serving import kv_cache as KV
from repro_torch.serving import kv_quant as KQ
from repro_torch.serving.api import (EngineConfig, FinishReason,
                                     RequestOutput, RequestState, StreamEvent)
from repro_torch.serving.sampler import SamplingParams, sample_batched
from repro_torch.serving.scheduler import (PREFILL_BUCKETS, Active, Request,
                                           Scheduler)


@dataclasses.dataclass
class EngineStats:
    """Plain counters of one engine (``repro``'s names)."""
    tokens_generated: int = 0
    prefill_tokens: int = 0
    steps: int = 0
    wall_s: float = 0.0
    prefix_hit_pages: int = 0
    prefix_hit_tokens: int = 0
    peak_active: int = 0


class Engine:
    def __init__(self, model: LM, config: Optional[EngineConfig] = None):
        config = config if config is not None else EngineConfig()
        self.config = config
        self.model = model
        self.eos_id = config.eos_id
        self.device = model.device
        self.sched = Scheduler()
        self.clock = config.clock if config.clock is not None \
            else CLK.SYSTEM_CLOCK
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.stats = EngineStats()
        self._next_rid = 0
        self._requests: dict[int, Request] = {}
        self._events: list[StreamEvent] = []
        self._admit_round: list[Request] = []

        cfg = model.cfg
        cache_dtype = config.cache_dtype or KV.DEFAULT_CACHE_DTYPE
        kvq = config.kv_quant                 # int8 or None (EngineConfig)
        self.kv_quant = kvq
        # what the cache payloads are stored as (int8 when quantized)
        self.cache_dtype = torch.int8 if kvq is not None else cache_dtype
        max_pages = -(-config.max_len // config.page_size)
        if config.page_pool_bytes is not None:
            # int8 KV buys about twice the pages of bf16 from one budget
            num_pages = KQ.num_pages_for_budget(
                config.page_pool_bytes, cfg.num_layers, cfg.num_kv_heads,
                cfg.head_dim, config.page_size, dtype=cache_dtype,
                kv_quant=kvq)
        elif config.num_pages is not None:
            num_pages = config.num_pages
        else:
            num_pages = KQ.default_num_pages(config.batch_slots,
                                             config.max_len, config.page_size)
        self.pc = KV.PagedCache(num_pages, config.page_size,
                                max_seqs=config.batch_slots,
                                max_pages=max_pages, dtype=cache_dtype,
                                kv_quant=kvq, device=self.device)
        self.cache = model.init_paged_cache(num_pages, config.page_size,
                                            dtype=cache_dtype, kv_quant=kvq)
        self.batch_rows = config.batch_slots
        self._width_buckets = (1, *PREFILL_BUCKETS)

    # ---------------------------------------------------------- fused step
    def _fused_step(self, tokens: np.ndarray, chunk_lens: np.ndarray,
                    live: np.ndarray, emit: np.ndarray,
                    samp: Optional[tuple]) -> torch.Tensor:
        """THE engine program: one forward over every row's chunk, then
        greedy or sampled choice of each emitting row's next token.  Cache
        writes cover ``chunk_lens`` positions of live rows; ``seq_lens``
        advances by the same.  Returns the packed (B, 2) int32
        ``[n_emit | token]`` on the device."""
        dev = self.device
        pc = self.pc
        tok = torch.from_numpy(tokens).to(dev)
        cl = torch.from_numpy(chunk_lens).to(dev)
        live_t = torch.from_numpy(live).to(dev)
        emit_t = torch.from_numpy(emit).to(dev) & live_t
        wl = torch.where(live_t, cl, 0)
        # the last real position of each row scores its next token
        last, self.cache = self.model.forward_chunks(
            tok, wl, self.cache, pc.seq_lens, block_tables=pc.block_tables,
            logit_index=(cl - 1).clamp(min=0))
        if samp is None:
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
        else:
            greedy, temps, top_ks, top_ps = (torch.from_numpy(a).to(dev)
                                             for a in samp)
            nxt = sample_batched(last, self.generator, greedy=greedy,
                                 temps=temps, top_ks=top_ks, top_ps=top_ps)
        pc.seq_lens += wl
        return torch.stack([emit_t.to(torch.int32),
                            torch.where(emit_t, nxt, 0)], dim=1)

    # -------------------------------------------------------------- lifecycle
    def submit(self, tokens: list[int], max_new_tokens: int = 32,
               sampling: SamplingParams = SamplingParams(greedy=True), *,
               stop_token_ids: Sequence[int] = (), ignore_eos: bool = False,
               priority: int = 0) -> int:
        """Queue one request; returns its rid.  Validates the prompt, the
        sampling parameters and that the page pool can ever hold the
        request."""
        tokens = list(tokens)
        if not tokens:
            raise ValueError("empty prompt")
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be > 0, got "
                             f"{max_new_tokens}")
        sampling.validate(self.model.cfg.vocab_size)
        need = self.pc.pages_needed(len(tokens) + max_new_tokens)
        cap = min(self.pc.max_pages, self.pc.num_pages)
        if need > cap:
            raise ValueError(
                f"request needs {need} pages (prompt {len(tokens)} + max_new "
                f"{max_new_tokens} tokens) but the pool can never provide "
                f"more than {cap}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, tokens=tokens, max_new_tokens=max_new_tokens,
                      sampling=sampling, arrival=self.clock.now(),
                      stop_token_ids=tuple(stop_token_ids),
                      ignore_eos=ignore_eos, priority=priority)
        self._requests[rid] = req
        self.sched.submit(req)
        return rid

    def state_of(self, rid: int) -> RequestState:
        return self._requests[rid].state

    def abort(self, rid: int) -> Optional[RequestOutput]:
        """Cancel a queued or in-flight request, releasing its pages (prefix
        refcounts included) at once.  Returns the partial output, or None
        for an unknown or finished rid."""
        req = self.sched.cancel(rid)
        if req is not None:
            req.state = RequestState.ABORTED
            out = RequestOutput(rid=rid, prompt_len=len(req.tokens),
                                output=[], arrival=req.arrival,
                                t_first_token=0.0, t_done=self.clock.now(),
                                finish_reason=FinishReason.ABORT)
        else:
            hit = self.sched.find_active(rid)
            if hit is None:
                return None
            out = self._finish(hit[0], [], FinishReason.ABORT)
        self._events.append(StreamEvent(
            rid=rid, token=None, index=len(out.output),
            finish_reason=FinishReason.ABORT, output=out))
        return out

    def _stop_reason(self, a: Active) -> Optional[FinishReason]:
        tok, req = a.output[-1], a.req
        if tok in req.stop_token_ids:
            return FinishReason.STOP
        if not req.ignore_eos and tok == self.eos_id:
            return FinishReason.STOP
        if len(a.output) >= req.max_new_tokens:
            return FinishReason.LENGTH
        return None

    def _emit_token(self, a: Active, row: int, tok: int,
                    finished: list[RequestOutput]):
        reason = self._stop_reason(a)
        out = self._finish(row, finished, reason) if reason else None
        self._events.append(StreamEvent(
            rid=a.req.rid, token=tok, index=len(a.output) - 1,
            finish_reason=reason, output=out))

    # -------------------------------------------------------------- admission
    def _prefix_pending(self, req: Request) -> bool:
        """True when a row still prefilling (or reserved earlier in this
        admission round) shares at least one full page with ``req``'s
        prompt: admitting ``req`` after that leader's prompt lands lets it
        share those pages."""
        ps = self.pc.page_size
        ctxs = [a.prefill_ctx for a in self.sched.active.values()
                if a.pending_prefill]
        ctxs += [r.tokens for r in self._admit_round]
        for ctx in ctxs:
            n = min(len(req.tokens), len(ctx)) // ps * ps
            lcp = next((i for i in range(n) if req.tokens[i] != ctx[i]), n)
            if lcp >= ps:
                return True
        return False

    def _reserve_paged(self, req: Request) -> bool:
        """Reserve the prompt + decode page footprint (minus prefix hits)
        and a block-table row, or defer."""
        if self._prefix_pending(req):
            return False
        if not self.pc.alloc_seq(req.rid, len(req.tokens), tokens=req.tokens,
                                 reserve=req.max_new_tokens):
            return False
        self._admit_round.append(req)
        return True

    def _admit_paged(self):
        pc = self.pc
        self._admit_round = []
        for req in self.sched.admit(self._reserve_paged):
            row = pc.row_of(req.rid)
            a = self.sched.activate(req, row)
            a.t_admit = self.clock.now()
            hit_pages = pc.prefix_hits.get(req.rid, 0)
            if hit_pages * pc.page_size >= len(req.tokens):
                # keep at least the last prompt token to sample from
                hit_pages = (len(req.tokens) - 1) // pc.page_size
                pc.release_prefix(req.rid, hit_pages)
                pc.prefix_hits[req.rid] = hit_pages
            hit_tokens = hit_pages * pc.page_size
            a.prefill_ctx = req.tokens
            a.prefill_pos = hit_tokens
            a.prefill_end = len(req.tokens)
            pc.seq_lens[row] = hit_tokens
            pc.lengths[req.rid] = hit_tokens
            self.stats.prefix_hit_pages += hit_pages
            self.stats.prefix_hit_tokens += hit_tokens

    def _finish(self, row: int, finished: list[RequestOutput],
                reason: FinishReason = FinishReason.STOP) -> RequestOutput:
        a = self.sched.retire(row)
        self.pc.free_seq(a.req.rid)
        a.req.state = (RequestState.ABORTED if reason is FinishReason.ABORT
                       else RequestState.FINISHED)
        out = RequestOutput(
            rid=a.req.rid, prompt_len=len(a.req.tokens), output=a.output,
            arrival=a.req.arrival, t_first_token=a.t_first_token,
            t_done=self.clock.now(), finish_reason=reason)
        finished.append(out)
        return out

    def _step_width(self, need: int) -> int:
        """Smallest of (1, *PREFILL_BUCKETS) holding ``need`` tokens;
        multiples of 4096 past the table."""
        for b in self._width_buckets:
            if need <= b:
                return b
        return -(-need // 4096) * 4096

    # ------------------------------------------------------------------- step
    def step(self) -> list[RequestOutput]:
        """One iteration: admissions, then one fused step over every live
        row's chunk."""
        t0 = self.clock.now()
        finished: list[RequestOutput] = []
        self._admit_paged()
        self.stats.peak_active = max(self.stats.peak_active,
                                     len(self.sched.active))
        if not self.sched.active:
            self.stats.wall_s += self.clock.now() - t0
            return finished
        bs = self.batch_rows
        plan = self.sched.plan_chunks(self.config.max_step_tokens, reserve=1)
        live = np.zeros((bs,), np.bool_)
        emit = np.zeros((bs,), np.bool_)
        chunk_lens = np.zeros((bs,), np.int32)
        greedy = np.ones((bs,), np.bool_)
        temps = np.ones((bs,), np.float32)
        top_ks = np.zeros((bs,), np.int32)
        top_ps = np.ones((bs,), np.float32)
        for row, a in self.sched.active.items():
            sp = a.req.sampling
            greedy[row] = sp.greedy or sp.temperature == 0.0
            temps[row] = sp.temperature if sp.temperature > 0.0 else 1.0
            top_ks[row] = sp.top_k
            top_ps[row] = sp.top_p
        width = self._step_width(max([1, *plan.values()]))
        tokens = np.zeros((bs, width), np.int32)
        for row, a in self.sched.active.items():
            if a.pending_prefill:
                continue
            live[row] = emit[row] = True
            chunk_lens[row] = 1
            tokens[row, 0] = a.output[-1] if a.output else a.req.tokens[-1]
        for row, c in plan.items():
            a = self.sched.active[row]
            live[row] = True
            chunk_lens[row] = c
            tokens[row, :c] = a.prefill_ctx[a.prefill_pos:a.prefill_pos + c]
            emit[row] = a.prefill_pos + c >= a.prefill_end
        samp = None if greedy.all() else (greedy, temps, top_ks, top_ps)
        packed_dev = self._fused_step(tokens, chunk_lens, live, emit, samp)
        packed = packed_dev.cpu().numpy()   # the step's one device->host copy
        decoded = 0
        for row in sorted(self.sched.active):
            a = self.sched.active[row]
            if not live[row]:
                continue
            if row in plan:
                self._advance_prefill(a, row, plan[row], packed, finished)
                continue
            self.pc.lengths[a.req.rid] += int(packed[row, 0])
            tok = int(packed[row, 1])
            decoded += 1
            a.output.append(tok)
            self._emit_token(a, row, tok, finished)
        self.stats.tokens_generated += decoded
        self.stats.steps += 1
        self.stats.wall_s += self.clock.now() - t0
        return finished

    def _advance_prefill(self, a: Active, row: int, c: int, packed,
                         finished: list[RequestOutput]) -> None:
        """Bookkeeping of one landed prefill chunk; the chunk that completes
        the prompt publishes its pages to the prefix cache and surfaces the
        first generated token."""
        req = a.req
        a.prefill_pos += c
        self.stats.prefill_tokens += c
        self.pc.lengths[req.rid] += c
        if a.pending_prefill:
            return
        self.pc.register_prefix(req.rid, a.prefill_ctx)
        tok = int(packed[row, 1])
        a.t_first_token = self.clock.now()
        a.output.append(tok)
        req.state = RequestState.RUNNING
        self._emit_token(a, row, tok, finished)

    # ---------------------------------------------------------------- drivers
    def drain_events(self) -> list[StreamEvent]:
        events, self._events = self._events, []
        return events

    def step_events(self) -> list[StreamEvent]:
        self.step()
        return self.drain_events()

    def run(self, *, max_steps: int = 10_000) -> list[RequestOutput]:
        """Drain the queue; returns the finished requests."""
        out: list[RequestOutput] = []
        steps = 0
        while not self.sched.idle and steps < max_steps:
            out.extend(self.step())
            self._events.clear()
            steps += 1
        return out

    def generate(self, prompts, *, max_new_tokens: int = 32,
                 sampling: SamplingParams = SamplingParams(greedy=True),
                 stop_token_ids: Sequence[int] = (), ignore_eos: bool = False,
                 max_steps: int = 10_000) -> list[RequestOutput]:
        """Submit ``prompts`` (one token list or a list of them) and step
        until they finish; outputs in submission order."""
        if prompts and isinstance(prompts[0], int):
            prompts = [prompts]
        rids = [self.submit(p, max_new_tokens=max_new_tokens,
                            sampling=sampling, stop_token_ids=stop_token_ids,
                            ignore_eos=ignore_eos) for p in prompts]
        want = set(rids)
        outs: dict[int, RequestOutput] = {}
        steps = 0
        while want and not self.sched.idle and steps < max_steps:
            for out in self.step():
                if out.rid in want:
                    outs[out.rid] = out
                    want.discard(out.rid)
            self._events.clear()
            steps += 1
        return [outs[r] for r in rids if r in outs]

    def stream(self, *, max_steps: int = 10_000) -> Iterator[StreamEvent]:
        """Step until idle, yielding one ``StreamEvent`` per generated token
        across all in-flight requests."""
        steps = 0
        while not self.sched.idle and steps < max_steps:
            yield from self.step_events()
            steps += 1
        yield from self.drain_events()

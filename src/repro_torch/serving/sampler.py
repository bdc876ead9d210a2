"""Token samplers (counterpart of ``repro.serving.sampler``): greedy /
temperature / top-k / top-p over independent rows, on the device, with an
explicit ``torch.Generator``.  ``torch.Generator`` and ``jax.random`` give
different numbers for the same seed, so only greedy output is comparable
token for token between the two packages."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0              # 0 = off
    top_p: float = 1.0          # 1.0 = off
    greedy: bool = False

    def validate(self, vocab_size: int | None = None):
        """Reject out-of-domain parameters at submit time (NaN fails)."""
        if not self.temperature >= 0.0:
            raise ValueError(f"temperature must be >= 0 (0 means greedy), "
                             f"got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (1.0 disables), got "
                             f"{self.top_p}")
        if not self.top_k >= 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got "
                             f"{self.top_k}")
        if vocab_size is not None and self.top_k >= vocab_size:
            raise ValueError(f"top_k must be < vocab size {vocab_size}, got "
                             f"{self.top_k}")


def filter_logits(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Temperature, then top-k, then top-p over rows of (N, V) logits.
    Returns float32 logits with ``-inf`` outside each row's nucleus."""
    v = logits.shape[-1]
    lf = logits.to(torch.float32) / temps.clamp(min=1e-6)[:, None]
    neg = torch.tensor(float("-inf"), device=lf.device)
    kth_idx = (v - top_ks.long()).clamp(0, v - 1)
    kth = torch.sort(lf, dim=-1).values.gather(1, kth_idx[:, None])
    lf = torch.where((top_ks[:, None] > 0) & (lf < kth), neg, lf)
    sorted_desc = torch.sort(lf, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = (cum < top_ps[:, None]).sum(dim=-1).clamp(0, v - 1)
    cutoff = sorted_desc.gather(1, cutoff_idx[:, None])
    return torch.where((top_ps[:, None] < 1.0) & (lf < cutoff), neg, lf)


def sample_batched(logits: torch.Tensor, generator: torch.Generator, *,
                   greedy: torch.Tensor, temps: torch.Tensor,
                   top_ks: torch.Tensor, top_ps: torch.Tensor
                   ) -> torch.Tensor:
    """Per-row parameterized sampling on the device.  logits (B, V); greedy
    (B,) bool; temps (B,) > 0; top_ks (B,) int; top_ps (B,) float.  Sampled
    rows draw from the filtered distribution by the Gumbel-max trick (no
    host synchronization).  Returns (B,) int32."""
    greedy_toks = torch.argmax(logits, dim=-1)
    lf = filter_logits(logits, temps, top_ks, top_ps)
    u = torch.rand(lf.shape, generator=generator, device=lf.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = torch.argmax(lf + gumbel, dim=-1)
    return torch.where(greedy, greedy_toks, sampled).to(torch.int32)

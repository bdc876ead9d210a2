"""The paper's three optimizations as kernel strategy flags (a copy of
``repro.core.opt_strategies``).

On Hopper each flag has its native GPU form: ``accum_vmem`` (SMB) is a
register/shared-memory accumulator written back once instead of global
``atomicAdd`` split-K; ``packed_loads`` (VML) reads packed int32 nibble words
instead of pre-expanded int8 weights; ``mxu`` (ILA) is tensor-core or fused
FMA arithmetic instead of a scalar loop.  This slice ports the OPT4GPTQ
lane only; the ablation kernels come later (ROADMAP Queue B).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelStrategy:
    name: str
    fused: bool = True
    accum_vmem: bool = False
    packed_loads: bool = False
    mxu: bool = False


NAIVE = KernelStrategy("naive", fused=False, accum_vmem=False,
                       packed_loads=False, mxu=True)
BASELINE = KernelStrategy("baseline")
SMB = KernelStrategy("smb", accum_vmem=True)
VML = KernelStrategy("vml", packed_loads=True)
ILA = KernelStrategy("ila", mxu=True)
OPT4GPTQ = KernelStrategy("opt4gptq", accum_vmem=True, packed_loads=True,
                          mxu=True)

STRATEGIES = {s.name: s for s in [NAIVE, BASELINE, SMB, VML, ILA, OPT4GPTQ]}


def get_strategy(name: str) -> KernelStrategy:
    try:
        return STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown kernel strategy {name!r}; "
                       f"available: {sorted(STRATEGIES)}") from None

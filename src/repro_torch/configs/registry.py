"""Architecture registry of the port: the configs this slice serves and
their reduced smoke variants (same rule as ``repro.configs.smoke_config``)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = ["qwen3_4b"]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise KeyError(f"config {arch!r} is not ported yet; available: "
                       f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: 4 layers, d_model 128, head_dim 32,
    at most 4 heads, vocab 512, fp32."""
    cfg = get_config(arch)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads) or heads
    return dataclasses.replace(
        cfg, num_layers=min(cfg.num_layers, 4), d_model=128,
        num_heads=heads, num_kv_heads=kv, head_dim=32,
        d_ff=256 if cfg.d_ff else 0, vocab_size=512, dtype="float32")

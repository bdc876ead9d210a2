"""Carry a ``repro`` (JAX) parameter tree across to the port's modules.

``params_from_jax`` takes the tree after ``jax.tree_util.tree_map(
np.asarray, params)``: nested dicts of numpy arrays, layers stacked on a
leading axis under ``group0``, quantized projections as leaves with the
attributes ``qweight``, ``scales``, ``qzeros``, ``perm``, ``bias``,
``shape`` and ``group_size``.  Leaves are read by duck typing, so this
module needs neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gptq import QuantizedLinear
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention import GQA
from repro_torch.models.blocks import Block
from repro_torch.models.ffn import MLP
from repro_torch.models.model import LM


def to_tensor(a, device) -> torch.Tensor:
    """numpy array (bfloat16 included, via its bits) -> tensor on device.
    Copies, so read-only arrays (jax's) give ordinary writable tensors."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _linear(p: dict, i: int, device) -> L.Linear:
    w = p["w"]
    b = p.get("b")
    b = None if b is None else to_tensor(b[i], device)
    if hasattr(w, "qweight"):
        ql = QuantizedLinear(
            qweight=to_tensor(w.qweight[i], device),
            scales=to_tensor(w.scales[i], device),
            qzeros=to_tensor(w.qzeros[i], device),
            perm=None if w.perm is None else to_tensor(w.perm[i], device),
            bias=None if w.bias is None else to_tensor(w.bias[i], device),
            shape=tuple(int(v) for v in w.shape),
            group_size=int(w.group_size))
        return L.Linear(ql, b)
    return L.Linear(to_tensor(w[i], device), b)


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """Build the port's ``LM`` holding the same weights as ``tree``."""
    dev = resolve_device(device)
    g = tree["group0"]
    layers = []
    for i in range(cfg.num_layers):
        a = g["attn"]
        attn = GQA(_linear(a["wq"], i, dev), _linear(a["wk"], i, dev),
                   _linear(a["wv"], i, dev), _linear(a["wo"], i, dev),
                   q_norm=to_tensor(a["q_norm"][i], dev) if cfg.qk_norm
                   else None,
                   k_norm=to_tensor(a["k_norm"][i], dev) if cfg.qk_norm
                   else None)
        f = g["ffn"]
        ffn = MLP(_linear(f["w_gate"], i, dev), _linear(f["w_up"], i, dev),
                  _linear(f["w_down"], i, dev))
        layers.append(Block(to_tensor(g["norm1"]["scale"][i], dev), attn,
                            to_tensor(g["norm2"]["scale"][i], dev), ffn))
    return LM(cfg, to_tensor(tree["embed"]["embedding"], dev), layers,
              to_tensor(tree["final_norm"]["scale"], dev))

"""int4 <-> int32 packing for GPTQ weights (the AutoGPTQ interchange layout).

``qweight[K // 8, N] : int32`` — word ``qweight[i, n]`` holds the nibbles of
rows ``8*i .. 8*i+7`` of column ``n``, row ``8*i`` in the least significant
nibble.  ``qzeros[G, N // 8] : int32`` packs zero points along N the same
way.  The words are *signed* int32, so every shift treats them as unsigned
32-bit values: torch widens to int64 and masks with ``0xFFFFFFFF`` (PyTorch
has no general uint32 arithmetic), numpy shifts ``uint32`` directly.
"""
from __future__ import annotations

import numpy as np
import torch

NIBBLES_PER_WORD = 8  # 8 x int4 per int32
_U32 = 0xFFFFFFFF


def _shifts(device) -> torch.Tensor:
    return 4 * torch.arange(NIBBLES_PER_WORD, dtype=torch.int64, device=device)


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> the same bits as int32."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_int4_rows(w_int4: torch.Tensor) -> torch.Tensor:
    """(K, N) values in [0, 15] -> (K // 8, N) int32, packed along K."""
    k, n = w_int4.shape
    if k % NIBBLES_PER_WORD:
        raise ValueError(f"K={k} not divisible by {NIBBLES_PER_WORD}")
    w = w_int4.to(torch.int64).reshape(k // NIBBLES_PER_WORD,
                                       NIBBLES_PER_WORD, n)
    words = (w << _shifts(w.device)[None, :, None]).sum(dim=1)
    return _to_int32(words)


def unpack_int4_rows(qweight: torch.Tensor, k: int | None = None
                     ) -> torch.Tensor:
    """(K // 8, N) int32 -> (K, N) int8 nibble values."""
    kw, n = qweight.shape
    q = qweight.to(torch.int64) & _U32
    nib = (q[:, None, :] >> _shifts(q.device)[None, :, None]) & 0xF
    out = nib.reshape(kw * NIBBLES_PER_WORD, n).to(torch.int8)
    return out if k is None else out[:k]


def pack_int4_cols(z_int4: torch.Tensor) -> torch.Tensor:
    """(G, N) values in [0, 15] -> (G, N // 8) int32, packed along N."""
    g, n = z_int4.shape
    if n % NIBBLES_PER_WORD:
        raise ValueError(f"N={n} not divisible by {NIBBLES_PER_WORD}")
    z = z_int4.to(torch.int64).reshape(g, n // NIBBLES_PER_WORD,
                                       NIBBLES_PER_WORD)
    words = (z << _shifts(z.device)[None, None, :]).sum(dim=2)
    return _to_int32(words)


def unpack_int4_cols(qzeros: torch.Tensor, n: int | None = None
                     ) -> torch.Tensor:
    """(G, N // 8) int32 -> (G, N) int8 zero points."""
    g, nw = qzeros.shape
    q = qzeros.to(torch.int64) & _U32
    nib = (q[:, :, None] >> _shifts(q.device)[None, None, :]) & 0xF
    out = nib.reshape(g, nw * NIBBLES_PER_WORD).to(torch.int8)
    return out if n is None else out[:, :n]


# ---------------------------------------------------------------- numpy twins
def np_pack_int4_rows(w_int4: np.ndarray) -> np.ndarray:
    k, n = w_int4.shape
    if k % NIBBLES_PER_WORD:
        raise ValueError(f"K={k} not divisible by {NIBBLES_PER_WORD}")
    w = w_int4.astype(np.uint32).reshape(k // NIBBLES_PER_WORD,
                                         NIBBLES_PER_WORD, n)
    shifts = (4 * np.arange(NIBBLES_PER_WORD, dtype=np.uint32))[None, :, None]
    return np.sum(w << shifts, axis=1, dtype=np.uint32).astype(np.int32)


def np_unpack_int4_rows(qweight: np.ndarray, k: int | None = None
                        ) -> np.ndarray:
    kw, n = qweight.shape
    q = qweight.astype(np.uint32)
    shifts = (4 * np.arange(NIBBLES_PER_WORD, dtype=np.uint32))[None, :, None]
    nib = (q[:, None, :] >> shifts) & np.uint32(0xF)
    out = nib.reshape(kw * NIBBLES_PER_WORD, n).astype(np.int8)
    return out if k is None else out[:k]

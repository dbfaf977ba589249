"""The packed layer-0 beam as one CUDA kernel per call
(``csrc/beam_packed.cu``, K3).

:func:`beam_packed` runs every query's whole E=1 walk over the packed rows
(``search.pack_layer``) in one launch: the function of
``search._beam_loop`` at ``expand_e == 1`` over ``search.unpack_rows``,
query by query (the kernel's source note says why that is the same
function). That loop is its plain version: ``search.search_layer_packed``
takes it for CPU tensors and for E > 1, and launches this kernel for every
E=1 walk on CUDA tensors. The kernel is built and loaded by
:mod:`.cuda_build`; past its limits, or on a CUDA error, it raises and
never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5)


def beam_packed(packed: torch.Tensor, q: torch.Tensor, entry_d2: torch.Tensor,
                entry_ids: torch.Tensor, ef: int, max_iters: int,
                ring_size: int, forbid: torch.Tensor | None = None,
                tally: torch.Tensor | None = None):
    """The sorted beams ``(d2 f32[B, ef], ids i32[B, ef])`` of the E=1
    walk from entries ``(entry_d2 [B, k0], entry_ids [B, k0])`` over
    ``packed`` u8[N, cap*(d+12)] for queries ``q`` f32[B, d], and the
    largest per-query expansion count as an i32 device scalar (the
    lockstep loop's iteration count). ``forbid`` i32[B]: an id never
    entered. ``tally`` (i64[1 + 2*cap], on the device): when given, the
    kernel adds the expansions, then per row slot the valid and the new
    neighbours (``search._beam_merge``'s layout). Counted in
    ``beam_packed.launches``.

    Limits (those of the C launch): ``d <= cuda_build.MAX_DIM``, ``cap <=
    128``, ``ef <= 4096``, ``cap <= ring_size <= 8192`` and fewer than
    2^30 rows (the beam packs a flag into each id's low bit); past them it
    raises ValueError. With no query it launches nothing."""
    b, d = q.shape
    n, w = packed.shape
    cap = w // (d + 12)
    if not (1 <= d <= cuda_build.MAX_DIM and 1 <= cap <= 128
            and 1 <= ef <= 4096 and cap <= ring_size <= 8192
            and 1 <= n < 2**30 and w == cap * (d + 12)):
        raise ValueError(f"beam kernel limits: n={n}, cap={cap}, d={d}, "
                         f"ef={ef}, ring_size={ring_size}, width={w}")
    dev = q.device
    for name, t in (("packed", packed), ("entry_d2", entry_d2),
                    ("entry_ids", entry_ids), ("forbid", forbid),
                    ("tally", tally)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if dev.type != "cuda" or packed.dtype != torch.uint8:
        raise TypeError("the beam kernel takes u8 packed rows on a CUDA device")
    if tally is not None and (tally.dtype != torch.int64
                              or tally.numel() != 1 + 2 * cap):
        raise ValueError(f"tally must be i64[{1 + 2 * cap}]")
    packed = packed.contiguous()
    q = q.to(torch.float32).contiguous()
    entry_d2 = entry_d2.to(torch.float32).contiguous()
    entry_ids = entry_ids.to(torch.int32).contiguous()
    if forbid is not None:
        forbid = forbid.to(torch.int32).contiguous()
    k0 = entry_ids.shape[1]
    out_d2 = torch.empty((b, ef), dtype=torch.float32, device=dev)
    out_ids = torch.empty((b, ef), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d2, out_ids, torch.zeros((), dtype=torch.int32, device=dev)
    work = torch.empty(2, dtype=torch.int32, device=dev)
    cuda_build.launch(
        "beam_packed", "beam_packed_launch", _ARGTYPES, dev,
        packed.data_ptr(), n, cap, d, q.data_ptr(), entry_d2.data_ptr(),
        entry_ids.data_ptr(), k0, None if forbid is None else forbid.data_ptr(),
        b, ef, min(int(max_iters), 2**31 - 1), int(ring_size), out_d2.data_ptr(),
        out_ids.data_ptr(), work.data_ptr(),
        None if tally is None else tally.data_ptr())
    beam_packed.launches += 1
    return out_d2, out_ids, work[1]


beam_packed.launches = 0

"""The probed seed stage of the packed probe route as one CUDA kernel per
query chunk (``csrc/probe_packed.cu``, K4).

:func:`probe_packed` scores each query's probed shortlist rows and reduces
the pool of seeds and members to its ef best distinct candidates in one
launch: the function of ``search._probe_stage`` over
``search._score_probe_packed`` (the probe loop, then
``search._top_ef_dedup_oversampled``) for one chunk, query by query, with
the oversampled top-s made exact at its boundary (the kernel's source note
says what it keeps). That Python path is its plain version:
``search.ann_search_seeded_probe_packed`` keeps it for CPU tensors and
hands this kernel to ``search._probe_seeds`` for CUDA tensors
(``search._packed_probe_stage``). The kernel is built and loaded by
:mod:`.cuda_build`; past its limits, or on a CUDA error, it raises and
never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)

MAX_T = 4096
MAX_EF = 4096
MAX_POOL = 65535  # seeds + probes * T
MAX_SMEM = 231_424  # the kernel's dynamic shared memory: 227 KB less 1 KB
_BINS = 2048


def _up16(x: int) -> int:
    return (x + 15) & ~15


def _pow2ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def smem_bytes(t: int, d: int, seeds: int, probes: int, ef: int) -> int:
    """The kernel's dynamic shared memory for one block (``layout`` in
    ``csrc/probe_packed.cu``): the query, the pool's d2 keys, and the larger
    of two row stages and the selection's scratch."""
    w = seeds + probes * t
    s = min(4 * ef, w)
    h, p2 = _pow2ceil((4 * s + 2) // 3), _pow2ceil(s)
    stage = _up16(t * d) + _up16(8 * t) + _up16(4 * t)
    scratch = 3 * _up16(4 * s) + max(12 * h, 8 * p2, 4 * _BINS)
    return _up16(4 * d) + _up16(4 * w) + max(2 * stage, scratch)


def probe_packed(shortlist_pack: torch.Tensor, t: int, q: torch.Tensor,
                 e_d2: torch.Tensor, e_ids: torch.Tensor, pos: torch.Tensor,
                 ef: int, probes: int):
    """The probed seeds ``(d2 f32[B, ef'], ids i32[B, ef'])``, ef' =
    min(ef, pool width), of queries ``q`` f32[B, d] from their pivot seeds
    ``(e_d2, e_ids)`` [B, E] and the seeds' pivot positions ``pos``
    [B, E']: the rows ``shortlist_pack[pos[:, i]]`` for i < min(probes, E')
    (``search.pack_layer`` over the shortlist, u8[P, t*(d+12)]) scored and
    merged with the seeds, sorted by (d2, id) with (+inf, PAD_ID) pads.
    Counted in ``probe_packed.launches``.

    Limits (those of the C launch): ``d <= cuda_build.MAX_DIM``, ``t <=
    4096``, ``ef <= 4096``, a pool (E + min(probes, E') * t) of at most
    65,535 entries, and a block's shared memory (:func:`smem_bytes`) of at
    most ``MAX_SMEM`` bytes; past them it raises ValueError. With no query
    it launches nothing."""
    b, d = q.shape
    n, w = shortlist_pack.shape
    e = e_ids.shape[1]
    probes_used = min(int(probes), pos.shape[1])
    pool = e + probes_used * t
    if not (1 <= d <= cuda_build.MAX_DIM and 1 <= t <= MAX_T
            and 1 <= ef <= MAX_EF and 1 <= e and probes >= 0
            and pool <= MAX_POOL and 1 <= n and w == t * (d + 12)
            and smem_bytes(t, d, e, probes_used, ef) <= MAX_SMEM):
        raise ValueError(f"probe kernel limits: rows={n}, t={t}, d={d}, "
                         f"ef={ef}, seeds={e}, probes={probes}, width={w}")
    if (tuple(e_d2.shape) != (b, e) or pos.dim() != 2
            or pos.shape[0] != b):
        raise ValueError(f"shapes q {tuple(q.shape)}, e_d2 {tuple(e_d2.shape)}, "
                         f"e_ids {tuple(e_ids.shape)}, pos {tuple(pos.shape)}")
    dev = q.device
    for name, x in (("shortlist_pack", shortlist_pack), ("e_d2", e_d2),
                    ("e_ids", e_ids), ("pos", pos)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if dev.type != "cuda" or shortlist_pack.dtype != torch.uint8:
        raise TypeError("the probe kernel takes u8 packed rows on a CUDA device")
    shortlist_pack = shortlist_pack.contiguous()
    q = q.to(torch.float32).contiguous()
    e_d2 = e_d2.to(torch.float32).contiguous()
    e_ids = e_ids.to(torch.int32).contiguous()
    pos = pos.to(torch.int64).contiguous()
    efo = min(ef, pool)
    out_d2 = torch.empty((b, efo), dtype=torch.float32, device=dev)
    out_ids = torch.empty((b, efo), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d2, out_ids
    work = torch.empty(1, dtype=torch.int32, device=dev)
    cuda_build.launch(
        "probe_packed", "probe_packed_launch", _ARGTYPES, dev,
        shortlist_pack.data_ptr(), n, t, d, q.data_ptr(), e_d2.data_ptr(),
        e_ids.data_ptr(), e, pos.data_ptr(), pos.shape[1], int(probes), b, ef,
        out_d2.data_ptr(), out_ids.data_ptr(), work.data_ptr())
    probe_packed.launches += 1
    return out_d2, out_ids


probe_packed.launches = 0

"""Native host helpers, C++ through ctypes (port of
``hnsw_rs_tpu/native/__init__.py``).

``fastio.cpp`` (the GloVe text parser, positioned block reads, the
paged tier's cold-row assembler and a single-pass host quantizer) and
``baseline_hnsw.cpp`` (a single-core sequential HNSW build and query
loop: the host's CPU baseline) are copies of the JAX package's sources.
Each is compiled at first use with ``g++ -O3 -march=native -shared
-fPIC`` into ``build/native/`` under the checkout. A library's name
carries a hash of its source, the flags and the host's CPU (model and
instruction-set flags from ``/proc/cpuinfo``), so a ``build/`` carried
to another host is rebuilt there, not run; the compile goes to a temporary name and is moved into
place under a file lock, so processes that build at once get one
library.

Without ``g++`` on ``PATH`` every entry point returns None and the
callers take their numpy versions, as in the JAX package; with ``g++``
a failed compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_CACHE = _DIR.parents[1] / "build" / "native"
_SRC = _DIR / "fastio.cpp"
_BASE_SRC = _DIR / "baseline_hnsw.cpp"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
WORD_CAP = 64  # bytes a parsed GloVe word keeps

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL | None] = {}


def cpu_info() -> dict[str, str]:
    """The first processor's fields in ``/proc/cpuinfo`` (``model name``,
    ``vendor_id``, ``flags``, ...); ``{"model name": <machine>}`` where
    the file is missing. Some hosts report the model name as
    ``unknown``: ``vendor_id``, ``cpu family`` and ``model`` still name
    the part, and ``flags`` what ``-march=native`` compiles for."""
    info: dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                k, _, v = line.partition(":")
                info[k.strip()] = v.strip()
    except OSError:
        pass
    return info or {"model name": platform.machine()}


def _library_path(src: Path) -> Path:
    info = cpu_info()
    key = hashlib.sha256(src.read_bytes())
    key.update(" ".join(_FLAGS).encode())
    for field in ("vendor_id", "cpu family", "model", "model name", "flags"):
        key.update(info.get(field, "").encode())
    return _CACHE / f"{src.stem}_{key.hexdigest()[:16]}.so"


def _compile(src: Path) -> Path | None:
    """The library built from ``src`` (compiled if missing), or None when
    no ``g++`` is on ``PATH``; raises if the compile fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    so = _library_path(src)
    if so.exists():
        return so
    _CACHE.mkdir(parents=True, exist_ok=True)
    with open(_CACHE / f"{src.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([gxx, *_FLAGS, str(src), "-o", str(tmp)],
                                 capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed for {src.name} (exit "
                                   f"{res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
    return so


def _load(src: Path, bind) -> ctypes.CDLL | None:
    with _lock:
        if src not in _libs:
            so = _compile(src)
            _libs[src] = None if so is None else bind(ctypes.CDLL(str(so)))
        return _libs[src]


def _bind_fastio(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    lib.glove_shape.restype = ctypes.c_int
    lib.glove_shape.argtypes = [ctypes.c_char_p, i64, ctypes.POINTER(i64),
                                ctypes.POINTER(i64)]
    lib.glove_parse.restype = i64
    lib.glove_parse.argtypes = [ctypes.c_char_p, i64, i64,
                                ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, i64]
    lib.pread_block.restype = i64
    lib.pread_block.argtypes = [ctypes.c_char_p, i64, i64, u8p]
    lib.assemble_packed_rows.restype = i64
    lib.assemble_packed_rows.argtypes = [
        ctypes.c_char_p, i64, i64, ctypes.c_char_p, i64, i64,
        ctypes.POINTER(i64), i64, u8p]
    lib.quantize_rows.restype = i64
    lib.quantize_rows.argtypes = [ctypes.POINTER(ctypes.c_float), i64, i64, u8p,
                                  ctypes.POINTER(ctypes.c_float)]
    return lib


def _bind_baseline(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    dblp = ctypes.POINTER(ctypes.c_double)
    lib.hnsw_baseline_build.restype = ctypes.c_int
    lib.hnsw_baseline_build.argtypes = [
        f32p, i64, i64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, dblp, dblp]
    lib.hnsw_baseline_query_rate.restype = ctypes.c_int
    lib.hnsw_baseline_query_rate.argtypes = [
        f32p, i64, i64, f32p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, dblp, ctypes.POINTER(ctypes.c_int32)]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded ``fastio`` library, or None without ``g++``."""
    return _load(_SRC, _bind_fastio)


def get_baseline_lib() -> ctypes.CDLL | None:
    """The loaded single-core baseline library, or None without ``g++``."""
    return _load(_BASE_SRC, _bind_baseline)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def assemble_packed_rows(adj_path: str, n: int, cap: int, blocks_path: str,
                         d: int, max_per_block: int, ids) -> np.ndarray | None:
    """Packed rows (``search.pack_layer``'s byte layout) of ``ids`` from a
    paged index's raw int32 layer-0 file and block file, in one pass over
    both memory maps: u8[K, cap*(d+12)], or None without ``g++``."""
    lib = get_lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
    out = np.empty((ids.size, cap * (d + 12)), np.uint8)
    got = lib.assemble_packed_rows(
        adj_path.encode(), n, cap, blocks_path.encode(), d, max_per_block,
        _ptr(ids, ctypes.c_int64), ids.size, _ptr(out, ctypes.c_uint8))
    if got != ids.size:
        raise OSError(f"assemble_packed_rows failed ({got}) on {adj_path}, "
                      f"{blocks_path}")
    return out


def quantize_rows(x: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """Single-pass per-vector u8 quantization on the host: (codes u8[n, d],
    scales f32[n, 2]) bit for bit equal to ``ops.quant.quantize_np``'s
    numpy path, or None without ``g++``."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    codes = np.empty((n, d), np.uint8)
    scales = np.empty((n, 2), np.float32)
    got = lib.quantize_rows(_ptr(x, ctypes.c_float), n, d,
                            _ptr(codes, ctypes.c_uint8), _ptr(scales, ctypes.c_float))
    if got != n:
        raise ValueError(f"quantize_rows failed on a [{n}, {d}] input")
    return codes, scales


def load_glove_native(path: str, limit: int = 0):
    """GloVe text parse -> (words, float32[N, d]), or None without
    ``g++``. Raises ValueError on a ragged row, OSError on an unreadable
    file; words are cut at ``WORD_CAP - 1`` bytes."""
    lib = get_lib()
    if lib is None:
        return None
    if os.path.getsize(path) == 0:
        return [], np.zeros((0, 0), np.float32)
    n, d = ctypes.c_int64(), ctypes.c_int64()
    if lib.glove_shape(path.encode(), limit, ctypes.byref(n), ctypes.byref(d)) != 0:
        raise OSError(f"cannot read {path}")
    n, d = n.value, d.value
    if n <= 0 or d <= 0:
        return [], np.zeros((0, 0), np.float32)
    out = np.empty((n, d), np.float32)
    words_buf = ctypes.create_string_buffer(n * WORD_CAP)
    got = lib.glove_parse(path.encode(), n, d, _ptr(out, ctypes.c_float),
                          words_buf, WORD_CAP)
    if got == -2:
        raise ValueError(f"ragged GloVe row in {path}")
    if got < 0:
        raise OSError(f"cannot read {path}")
    raw = words_buf.raw
    words = [raw[i * WORD_CAP:(i + 1) * WORD_CAP].split(b"\0", 1)[0]
             .decode("utf-8", "replace") for i in range(got)]
    return words, out[:got]


def pread_block(path: str, offset: int, nbytes: int) -> np.ndarray | None:
    """``nbytes`` of ``path`` from ``offset`` by a positioned read (fewer
    at the end of the file), or None without ``g++``."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(nbytes, np.uint8)
    got = lib.pread_block(path.encode(), offset, nbytes, _ptr(out, ctypes.c_uint8))
    if got < 0:
        raise OSError(f"pread of {path} at {offset} failed")
    return out[:got]


# -- the single-core CPU baseline (baseline_hnsw.cpp) --------------------------


def baseline_build_rate(vectors: np.ndarray, m: int, ef_cons: int = 0,
                        seed: int = 0) -> tuple[float, float] | None:
    """Single-core sequential HNSW build on this host's CPU: (seconds,
    vectors per second) of the insert loop, or None without ``g++``."""
    lib = get_baseline_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vectors, np.float32)
    secs, rate = ctypes.c_double(), ctypes.c_double()
    rc = lib.hnsw_baseline_build(_ptr(v, ctypes.c_float), v.shape[0], v.shape[1],
                                 m, ef_cons, seed, ctypes.byref(secs),
                                 ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"hnsw_baseline_build rejected its inputs ({rc})")
    return secs.value, rate.value


def baseline_query_rate(vectors: np.ndarray, queries: np.ndarray, m: int,
                        ef: int, k: int = 10, ef_cons: int = 0,
                        seed: int = 0) -> tuple[float, np.ndarray] | None:
    """Single-core one-query-at-a-time HNSW QPS on this host's CPU over an
    index it builds first (untimed): (qps, ids int32[nq, k]), or None
    without ``g++``."""
    lib = get_baseline_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vectors, np.float32)
    q = np.ascontiguousarray(queries, np.float32)
    qps = ctypes.c_double()
    ids = np.empty((q.shape[0], k), np.int32)
    rc = lib.hnsw_baseline_query_rate(
        _ptr(v, ctypes.c_float), v.shape[0], v.shape[1], _ptr(q, ctypes.c_float),
        q.shape[0], m, ef_cons, ef, k, seed, ctypes.byref(qps),
        _ptr(ids, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"hnsw_baseline_query_rate rejected its inputs ({rc})")
    return qps.value, ids

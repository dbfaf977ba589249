"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled on its own by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/torch_kernels/`` under the checkout. A library's name carries a
hash of its source, of every shared header (``csrc/*.cuh``) and of the
compile command, so an edited source or header is rebuilt and an
unchanged one is reused. :func:`build` starts one ``nvcc``
per missing library, all at once, and waits for them together. The
compiler's output, the ``-Xptxas -v`` register and shared-memory report
included, is kept beside each library with a ``.log`` suffix. Libraries
are loaded with ``ctypes``; nothing here runs when the module is
imported.

The kernels' wrappers share :func:`check_inputs` (the (q, codes, scales,
normsq) argument rules) and :func:`launch` (load, launch on the current
stream, raise on a CUDA error); what they pass is prepared by
``ops/limbs.tensor_core_operands``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_DIM = 768  # csrc/dist_core.cuh: dist::kMaxDim

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives; the key
    covers the source, every ``csrc/*.cuh`` and the flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode())
        key.update(header.read_bytes())
    key.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"


def build(*names: str) -> list[Path]:
    """Compile ``csrc/<name>.cu`` for each name whose library is missing,
    one ``nvcc`` process per source, all started together. Returns the
    library paths in the order of ``names``; raises if any compile
    fails."""
    outs = [library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outs


def load(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library (built
    first if needed), with its argument types set and an ``int`` result:
    the CUDA error code of the launch."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)[0]))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_inputs(q, codes, scales, normsq) -> None:
    """The argument rules of the distance kernels: ``q`` f32[B, d],
    ``codes`` u8[N, d], ``scales`` f32[N, 2], ``normsq`` f32[N], all
    contiguous and on ``q``'s device."""
    if q.dim() != 2 or codes.dim() != 2 or q.shape[1] != codes.shape[1]:
        raise ValueError(f"shapes q {tuple(q.shape)}, codes {tuple(codes.shape)}")
    n = codes.shape[0]
    if tuple(scales.shape) != (n, 2) or tuple(normsq.shape) != (n,):
        raise ValueError("scales must be [N, 2] and normsq [N]")
    for name, t, dt in (("q", q, torch.float32), ("codes", codes, torch.uint8),
                        ("scales", scales, torch.float32),
                        ("normsq", normsq, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    if q.device.type == "cuda" and q.shape[1] > MAX_DIM:
        raise ValueError(f"d={q.shape[1]} exceeds the kernels' limit of {MAX_DIM}")


def launch(name: str, symbol: str, argtypes: list, device: torch.device,
           *args) -> None:
    """Call ``symbol`` of ``csrc/<name>.cu`` with ``args`` and ``device``'s
    current stream as its last argument; raises on a CUDA error."""
    fn = load(name, symbol, argtypes)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {rc}")

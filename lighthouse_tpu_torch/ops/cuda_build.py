"""Build a CUDA source of ``../csrc`` with nvcc and bind it with ctypes.

One shared library per source, built at first use into
``lighthouse_tpu_torch/build/`` and keyed by a hash of the source and of
every header it reaches through ``#include "..."`` (headers included by
headers too), with a plain C interface (no PyTorch headers: seconds to
build, not minutes). A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}: set CUDA_HOME")
    return str(path)


def ptxas_usage(ptxas_log: str) -> dict:
    """Registers, spill bytes and stack frame of each kernel from
    `nvcc -Xptxas -v`, keyed by the kernel's (mangled) name."""
    out: dict = {}
    name = None
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or re.search(
            r"Function properties for (\S+)", line
        )
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        st = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if st:
            out[name].update(
                stack_frame_bytes=int(st.group(1)),
                spill_store_bytes=int(st.group(2)),
                spill_load_bytes=int(st.group(3)),
            )
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[name]["registers"] = int(regs.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


class CudaLibrary:
    """A CUDA source and the C signatures of its launchers, loaded once.

    `functions` maps a launcher's name to its argument kinds: "p" a pointer
    (a tensor's data_ptr() or the stream), "i64" a 64-bit int, "i32" an int.
    Every launcher returns the cudaError_t of its launch.
    """

    def __init__(self, source: str, functions: dict[str, tuple[str, ...]]):
        self.source = CSRC / source
        self.functions = functions
        self.info: dict = {}
        self._lib = None
        self._lock = threading.Lock()

    def _key(self) -> str:
        """A hash of the source and of each header it reaches through
        `#include "..."`, depth first, every file once; a header is looked
        up beside the source."""
        h = hashlib.sha256()
        seen: set[Path] = set()

        def visit(path: Path) -> None:
            if path in seen:
                return
            seen.add(path)
            data = path.read_bytes()
            h.update(data)
            for inc in re.findall(rb'#include "([^"]+)"', data):
                visit(self.source.parent / inc.decode())

        visit(self.source)
        return h.hexdigest()[:16]

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
        return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        so = BUILD_DIR / f"{self.source.stem}-{self._key()}.so"
        log = so.with_suffix(".ptxas.txt")
        built = not so.exists()
        t0 = time.perf_counter()
        if built:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [
                nvcc(),
                "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v",
                "-o", str(tmp), str(self.source),
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {self.source}:\n{proc.stderr}"
                )
            log.write_text(proc.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        kinds = {"p": _P, "i64": _I64, "i32": _I32}
        for fn, args in self.functions.items():
            f = getattr(lib, fn)
            f.argtypes = [kinds[a] for a in args]
            f.restype = ctypes.c_int
        self.info.update(
            so=str(so),
            built=built,
            build_s=time.perf_counter() - t0,
            ptxas=log.read_text() if log.exists() else "",
        )
        return lib

    def launch(self, fn: str, *args, device) -> None:
        """Call launcher `fn` on `device`'s current stream (appended as the
        last argument); raise on a refused launch."""
        import torch

        lib = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, fn)(*args, stream)
        if err:
            raise RuntimeError(f"{fn} launch failed with CUDA error {err}")

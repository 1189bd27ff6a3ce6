"""Build and load the port's CUDA kernels: `nvcc` into a shared library with
a plain C interface, loaded with `ctypes`.  No PyTorch headers and no
`torch.utils.cpp_extension`, so a cold build takes seconds.

The library is built at first CUDA use into `bulletproofs_tpu_torch/_build/`
(listed in `.gitignore`), named by a hash of the source and the flags, so an
edited source builds anew and an unchanged one is reused.  A failed build
raises with the compiler's output.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SOURCE = CSRC / "ec_kernels.cu"

# C signatures of SOURCE: every pointer and the stream are c_void_p
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "bp_bucket_rounds_mixed": (_P, _P, _P, _I, _I, _I, _P, _P),
    "bp_bucket_rounds_proj": (_P, _P, _P, _I, _I, _I, _P, _P),
    "bp_ec_add": (_P, _P, _P, _LL, _I, _P, _P),
    "bp_bucket_round_add": (_P, _P, _P, _I, _I, _P, _P),
}


def nvcc_path():
    """The toolkit's nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path():
    """Where `build()` puts the library for the current source."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def build():
    """Compile SOURCE unless the library for this source exists.
    Returns (library path, ptxas report: the compiler's stderr, empty when
    the library was already built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


@functools.cache
def load():
    """Build if needed, then load the library with its C signatures set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib

"""Build and load the port's CUDA kernels: `nvcc` into shared libraries with
a plain C interface, loaded with `ctypes`.  No PyTorch headers and no
`torch.utils.cpp_extension`, so a cold build takes seconds to a minute.

Each source of `SOURCES` is its own library: kernels 1-4 for a = 0 curves
in `csrc/ec_kernels.cu`, kernels 2-4 for a != 0 (ed25519) in
`csrc/ec_kernels_a.cu` (ec_kernels.cu built again, its C functions named
with "_a" at the end), kernel 5 in `csrc/mxu_kernels.cu` and the roofline
harness's chain kernel in `csrc/roofline_kernels.cu`, each including
`csrc/ec_lanes.cuh`, `csrc/ec_common.cuh` and `csrc/carry.cuh`, and the
fused IPA's `bp_ipa_challenge` in `csrc/transcript_kernels.cu` (including
`csrc/ec_common.cuh`).  The libraries are built at first CUDA use into
`bulletproofs_tpu_torch/_build/` (listed in `.gitignore`), one `nvcc` per
source, all started together; each is named by a hash of its source, the
files of `csrc/` it includes and the flags, so an edited source builds
anew and an unchanged one is reused.  A failed build raises with the
compiler's output.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures by source: every pointer and the stream are c_void_p
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_EC_KERNELS = {
    "bp_bucket_rounds_mixed": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    "bp_bucket_rounds_proj": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    "bp_ec_add": (_P, _P, _P, _LL, _I, _P, _P),
    "bp_bucket_round_add": (_P, _P, _P, _P, _P, _I, _I, _P, _P),
    "bp_ec_gather_sum": (_P, _P, _P, _I, _I, _LL, _I, _I, _P, _P),
    "bp_ec_window_totals": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "bp_ec_horner": (_P, _P, _I, _I, _I, _I, _P, _P),
}
SOURCES = {
    CSRC / "ec_kernels.cu": _EC_KERNELS,
    # kernel 1 is built for a = 0 only
    CSRC / "ec_kernels_a.cu": {f"{name}_a": sig
                               for name, sig in _EC_KERNELS.items()
                               if name != "bp_bucket_rounds_mixed"},
    CSRC / "mxu_kernels.cu": {
        "bp_bucket_round_add_mxu": (_P, _P, _P, _P, _P, _I, _I, _P, _P,
                                    _P),
    },
    CSRC / "roofline_kernels.cu": {
        "bp_ec_chain": (_P, _P, _LL, _I, _I, _I, _P, _P),
        "bp_mont_mul_chain": (_P, _P, _LL, _I, _I, _P, _P),
    },
    CSRC / "transcript_kernels.cu": {
        "bp_ipa_challenge": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                             _P),
        "bp_ipa_challenge_timed": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _P, _P, _P, _P),
    },
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


_INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)


def _inputs(source):
    """`source`, then the files of `csrc/` it includes, directly or not."""
    files = [source]
    for path in files:                      # grows while it is walked
        for name in _INCLUDE.findall(path.read_text()):
            if CSRC / name not in files:
                files.append(CSRC / name)
    return files


def library_path(source):
    """Where `build()` puts the library of `source` for its current text."""
    digest = hashlib.sha256()
    for path in _inputs(source):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build():
    """Compile every source whose library does not exist, all at once.
    Returns {library path: ptxas report}, the report being the compiler's
    stderr, empty for a library that was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports, running = {}, []
    for source in SOURCES:
        out = library_path(source)
        if out.exists():
            reports[out] = ""
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((out, tmp, cmd, proc))
    failed = []
    for out, tmp, cmd, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
        else:
            os.replace(tmp, out)
            reports[out] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.cache
def load():
    """Build if needed, then load every library with its C signatures set:
    -> a namespace of the C functions by name."""
    build()
    fns = {}
    for source, signatures in SOURCES.items():
        lib = ctypes.CDLL(str(library_path(source)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return SimpleNamespace(**fns)


_KERNEL_NAME = re.compile(r"((?:[a-z]+_)+kernel)IL[ij](\d+)E(Lb1E)?")


def ptxas_summary(report):
    """The `-Xptxas -v` report of one build -> [{kernel, registers,
    stack, spill_stores, spill_loads}] per entry function, the kernel named
    with its first template argument (limb words), and ", a!=0" after it
    for an instantiation of RCB16 algorithm 1 (GA true)."""
    out, cur = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = _KERNEL_NAME.search(mangled)
            name = (f"{m.group(1)}<{m.group(2)}"
                    f"{', a!=0' if m.group(3) else ''}>" if m else mangled)
            cur = {"kernel": name}
            out.append(cur)
        elif cur is not None and "stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    return out

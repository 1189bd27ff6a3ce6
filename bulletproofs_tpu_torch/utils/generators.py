"""Deterministic generator derivation (the Rust reference's
`src/utils/mod.rs:16-23`): the port's own copy of `get_generators` from
`bulletproofs_tpu/utils/generators.py`.

G_i = hash_to_curve(prefix || str(i+1)); no trusted setup, recomputable from
labels alone.  Hash-to-curve is host-serial Python (~4 ms a point), so a
2^16 set would cost minutes in every fresh process: sets are cached in the
process by (curve, prefix, n) and persisted to disk.

Disk format and validation are the JAX package's: plain JSON hex (no
pickle), every point checked on-curve, small files fully re-derived and
large ones spot-checked at fixed anchors and at indices drawn from
SystemRandom; any mismatch discards the file.  The file name carries the
same hash-to-curve schema tag, so with `BP_GENERATOR_CACHE` set both
packages read and write one cache.  Unset, the port keeps its cache in
`bulletproofs_tpu_torch/_cache/generators/` (ignored by git), inside the
checkout.
"""

import json
import os
import random
from functools import lru_cache
from pathlib import Path

from ..config import CURVES, curve
from ..ops.ec_host import G1

_DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_cache" / "generators"

# Indices re-derived from scratch on every disk load (plus the last entry).
_SPOT_CHECKS = 4

# Hash-to-curve semantics version, baked into the file name (the JAX
# package's tag: v2 = even-parity y selection + ed25519 Edwards mapit).
_SCHEMA = "v2"


def _disk_dir():
    return Path(os.environ.get("BP_GENERATOR_CACHE") or _DEFAULT_DIR)


def _disk_path(curve_name, prefix):
    return _disk_dir() / f"{curve_name}_{prefix}_{_SCHEMA}.json"


def _derive(prefix, i, cv):
    return G1.from_msg_hash(f"{prefix}{i + 1}".encode(), cv)


def _load_validated(path, prefix, cv):
    """Cached coordinates, or [] unless every point passes the on-curve and
    re-derivation checks."""
    try:
        with open(path, "r") as f:
            raw = json.load(f)
        coords = [(int(x, 16), int(y, 16), int(z, 16)) for x, y, z in raw]
    except (OSError, ValueError, TypeError):
        return []
    pts = []
    for X, Y, Z in coords:
        p = G1(X, Y, Z, cv)
        if not p.is_on_curve():
            return []
        pts.append(p)
    n = len(pts)
    if n <= 32:
        idxs = range(n)
    else:
        sysrand = random.SystemRandom()
        idxs = {0, n - 1}
        idxs.update(sysrand.randrange(n) for _ in range(_SPOT_CHECKS))
    for i in idxs:
        if pts[i] != _derive(prefix, i, cv):
            return []
    return coords


@lru_cache(maxsize=64)
def _cached(curve_name, prefix, n):
    cv = CURVES[curve_name]
    path = _disk_path(curve_name, prefix)
    coords = _load_validated(path, prefix, cv)
    if len(coords) < n:
        for i in range(len(coords), n):
            p = _derive(prefix, i, cv)
            coords.append((p.X, p.Y, p.Z))
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
            with open(tmp, "w") as f:
                json.dump([[hex(X), hex(Y), hex(Z)] for X, Y, Z in coords],
                          f)
            os.replace(tmp, path)                    # atomic
        except OSError:
            pass                                     # the cache is optional
    return tuple(G1(X, Y, Z, cv) for X, Y, Z in coords[:n])


def get_generators(prefix: str, n: int):
    """The first n generators of `prefix` on the active curve."""
    return list(_cached(curve().name, prefix, n))

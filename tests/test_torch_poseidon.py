"""The port's Poseidon (bulletproofs_tpu_torch: ops/poseidon_device.py,
`mont_sq` and `inv_mont` of ops/field.py, models/helper_constraints/
poseidon.py and non_zero.py, models/poseidon_hash.py) against the JAX
package, on the CPU.

The batched permutation is held against the JAX package's
`poseidon_permutation_batch` (XLA on the CPU) and the port's host
`Poseidon_permutation` on widths 3, 5 and 9, the three s-boxes and both
pairing curves; the field functions against `field_jax` limb for limb; the
hash wrappers against the JAX package's; and one proof of the three
preimage gadgets (2:1 with the Inverse s-box, 4:1 with Cube, 8:1 with
Quint, reduced rounds, n = 64) byte for byte against the JAX package's
native `Prover._prove`, each side's verifier accepting the other's proof.
Every comparison is exact.
"""

import contextlib
import random
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bulletproofs_tpu as jbp
from bulletproofs_tpu import backend as jbackend
from bulletproofs_tpu.config import CURVES as JCURVES
from bulletproofs_tpu.models import poseidon_hash as jph
from bulletproofs_tpu.models.helper_constraints import poseidon as jpos
from bulletproofs_tpu.ops import field_jax as fj
from bulletproofs_tpu.ops import poseidon_device as jpd

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch.config import CURVES, using_curve
from bulletproofs_tpu_torch.models import poseidon_hash as ph
from bulletproofs_tpu_torch.models.helper_constraints import poseidon as pos
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import poseidon_device as pd
from bulletproofs_tpu_torch.utils.errors import VerificationError

# One torch thread: the suite runs several test processes at once, and
# each process's own thread pool would oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# The reference's round schedules (full rounds at each end, partial
# rounds) per width (`poseidon_hash.rs:501-745`); the Inverse s-box costs
# ~380 products a round here, so its cases run one full and one partial
# round.
SCHEDULES = {3: (4, 4, 55), 5: (4, 4, 56), 9: (4, 4, 57)}
INVERSE_SCHEDULE = (1, 0, 1)
SBOXES = (pos.SboxType.Cube, pos.SboxType.Quint, pos.SboxType.Inverse)

PORT = SimpleNamespace(Scalar=bt.Scalar, G1=bt.G1, pos=pos, ph=ph,
                       Params=pos.PoseidonParams, Prover=bt.Prover,
                       Verifier=bt.Verifier, Transcript=bt.ProofTranscript,
                       gens=bt.get_generators, curves=CURVES)
JAX = SimpleNamespace(Scalar=jbp.Scalar, G1=jbp.G1, pos=jpos, ph=jph,
                      Params=jpos.PoseidonParams, Prover=jbp.Prover,
                      Verifier=jbp.Verifier, Transcript=jbp.ProofTranscript,
                      gens=jbp.get_generators, curves=JCURVES)


@contextlib.contextmanager
def _native():
    """The JAX package's native backend for its host proving and
    verifying, whatever backend an imported test module set."""
    old = jbackend._mode
    jbackend.set_backend("cpp")
    try:
        yield
    finally:
        jbackend.set_backend(old)


_PARAMS = {}


def _params(ns, width, schedule, curve="bls381"):
    """One parameter object per package, width, schedule and curve: the
    JAX package's batched permutation is compiled per object (a static
    argument of its jit), so a statement repeated on the same batch size
    reuses its compile."""
    key = (ns is JAX, width, schedule, curve)
    if key not in _PARAMS:
        rb, re, rp = schedule
        _PARAMS[key] = ns.Params(width, rb, re, rp, cv=ns.curves[curve])
    return _PARAMS[key]


def _columns(ns, ints, curve):
    return [[ns.Scalar(v, ns.curves[curve]) for v in col] for col in ints]


def test_constants_file_is_the_jax_packages():
    rel = "models/helper_constraints/poseidon_constants.json"
    assert (REPO / "bulletproofs_tpu_torch" / rel).read_bytes() == \
        (REPO / "bulletproofs_tpu" / rel).read_bytes()


@pytest.mark.parametrize("sbox", SBOXES)
@pytest.mark.parametrize("width", sorted(SCHEDULES))
@pytest.mark.parametrize("curve", ["bls381", "bn254"])
def test_permutation_batch_matches_jax_and_host(curve, width, sbox):
    """n = 5 permutations (not a power of two: the JAX package pads its
    batch) on the CPU against the JAX package's batch and the host."""
    schedule = INVERSE_SCHEDULE if sbox == pos.SboxType.Inverse \
        else SCHEDULES[width]
    rnd = random.Random(f"{curve}-{width}-{sbox}")
    r = CURVES[curve].r
    ints = [[rnd.randrange(r) for _ in range(5)] for _ in range(width)]
    got = pd.poseidon_permutation_batch(
        _columns(PORT, ints, curve), _params(PORT, width, schedule, curve),
        sbox, device="cpu")
    want = jpd.poseidon_permutation_batch(
        _columns(JAX, ints, curve), _params(JAX, width, schedule, curve),
        sbox)
    assert [[s.v for s in col] for col in got] == \
        [[s.v for s in col] for col in want]
    params = _params(PORT, width, schedule, curve)
    with using_curve(curve):          # the host's sums start at zero()
        for k in range(5):
            host = pos.Poseidon_permutation(
                [PORT.Scalar(col[k]) for col in ints], params, sbox)
            assert [col[k] for col in got] == host


def test_inverse_sbox_maps_zero_to_zero():
    """A state whose first s-box input is 0: the batched permutations of
    both packages map it to 0 (Fermat) and agree; the host raises."""
    curve, width = "bls381", 3
    params = _params(PORT, width, INVERSE_SCHEDULE)
    ints = [[(-params.round_keys[0].v) % CURVES[curve].r, 7], [1, 2],
            [3, 4]]
    got = pd.poseidon_permutation_batch(
        _columns(PORT, ints, curve), params, pos.SboxType.Inverse,
        device="cpu")
    want = jpd.poseidon_permutation_batch(
        _columns(JAX, ints, curve), _params(JAX, width, INVERSE_SCHEDULE),
        pos.SboxType.Inverse)
    assert [[s.v for s in col] for col in got] == \
        [[s.v for s in col] for col in want]
    with pytest.raises(ValueError):
        pos.Poseidon_permutation([PORT.Scalar(c[0]) for c in ints], params,
                                 pos.SboxType.Inverse)


@pytest.mark.parametrize("curve", ["bls381", "bn254"])
def test_inv_mont_and_mont_sq_match_field_jax(curve):
    cv = CURVES[curve]
    rnd = random.Random(curve)
    vals = [0, 1, 2, cv.r - 1] + [rnd.randrange(cv.r) for _ in range(4)]
    fr = F.FieldCtx(cv.fr)
    jfr = fj.FieldCtx(JCURVES[curve].fr)
    x = fr.to_mont(vals, "cpu")
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    for mine, theirs in ((F.inv_mont, fj.inv_mont),
                         (F.mont_sq, fj.mont_sq)):
        np.testing.assert_array_equal(
            mine(x, fr).numpy(),
            np.asarray(theirs(jx, jfr)).astype(np.int64))
    inv = fr.from_mont(F.inv_mont(x, fr))
    assert inv[0] == 0
    assert all(v * i % cv.r == 1 for v, i in zip(vals[1:], inv[1:]))


@pytest.mark.parametrize("arity", [2, 4, 8])
def test_hash_wrappers_match_jax(arity):
    """Poseidon_hash_{2,4,8} of both packages on the host, and the port's
    batched wrapper against its host wrapper."""
    width = {2: 3, 4: 5, 8: 9}[arity]
    rnd = random.Random(arity)
    ints = [[rnd.randrange(CURVES["bls381"].r) for _ in range(arity)]
            for _ in range(3)]
    outs = {}
    for name, ns in (("port", PORT), ("jax", JAX)):
        params = _params(ns, width, SCHEDULES[width])
        hash_fn = getattr(ns.pos, f"Poseidon_hash_{arity}")
        rows = [[ns.Scalar(v) for v in row] for row in ints]
        if arity == 2:
            outs[name] = [hash_fn(a, b, params, "quint") for a, b in rows]
        else:
            outs[name] = [hash_fn(row, params, "quint") for row in rows]
    assert [s.v for s in outs["port"]] == [s.v for s in outs["jax"]]
    params = _params(PORT, width, SCHEDULES[width])
    rows = [[PORT.Scalar(v) for v in row] for row in ints]
    if arity == 2:
        got = pd.poseidon_hash_2_batch([a for a, _ in rows],
                                       [b for _, b in rows], params,
                                       "quint", device="cpu")
    else:
        got = getattr(pd, f"poseidon_hash_{arity}_batch")(
            rows, params, "quint", device="cpu")
    assert got == outs["port"]


def test_batched_wrappers_take_empty_batches():
    params = _params(PORT, 5, SCHEDULES[5])
    assert pd.poseidon_hash_4_batch([], params, "quint", device="cpu") == []
    assert pd.poseidon_permutation_batch([[]] * 5, params, "quint",
                                         device="cpu") == [[]] * 5


# ---------------------------------------------------------------------------
# The preimage gadgets: one proof of all three, n = 64
# ---------------------------------------------------------------------------

# (arity, width, s-box) of each gadget; reduced rounds (one full, one
# partial) keep the statement at 54 multipliers
GADGETS = ((2, 3, pos.SboxType.Inverse), (4, 5, pos.SboxType.Cube),
           (8, 9, pos.SboxType.Quint))
LABEL = b"PoseidonPreimages"


def _gadget_params(ns, width):
    return _params(ns, width, INVERSE_SCHEDULE)


def _images(ns, inputs):
    out = []
    for (arity, width, sbox), xs in zip(GADGETS, inputs):
        params = _gadget_params(ns, width)
        hash_fn = getattr(ns.pos, f"Poseidon_hash_{arity}")
        out.append(hash_fn(*xs, params, sbox) if arity == 2
                   else hash_fn(xs, params, sbox))
    return out


def _prove_preimages(ns, prove, gens, **kw):
    """The three preimage statements on one Prover -> (proof bytes,
    commitments, images)."""
    rng = random.Random(0x9051)
    inputs = [[ns.Scalar.random(rng) for _ in range(arity)]
              for arity, _, _ in GADGETS]
    images = _images(ns, inputs)
    g, h = ns.G1.from_msg_hash(b"g"), ns.G1.from_msg_hash(b"h")
    p = ns.Prover(g, h, ns.Transcript(LABEL), rng=rng, **kw)
    comms = []
    for (arity, width, sbox), xs, image in zip(GADGETS, inputs, images):
        fn = getattr(ns.ph, f"prove_knowledge_of_preimage_of_Poseidon_"
                     f"{arity}")
        comms.append(fn(xs, None, image, _gadget_params(ns, width), sbox,
                        rng, p))
    assert p.num_multipliers() == 54
    proof = prove(p, ns.gens("G", gens), ns.gens("H", gens))
    return proof.to_bytes(), comms, images


def _verify_preimages(ns, blob, comms, images, bump=False, **kw):
    g, h = ns.G1.from_msg_hash(b"g"), ns.G1.from_msg_hash(b"h")
    v = ns.Verifier(ns.Transcript(LABEL), **kw)
    for (arity, width, sbox), c, image in zip(GADGETS, comms, images):
        fn = getattr(ns.ph, f"verify_knowledge_of_preimage_of_Poseidon_"
                     f"{arity}")
        fn(image + ns.Scalar(1) if bump else image,
           _gadget_params(ns, width), sbox, c, g, h, v)
    proof_cls = bt.R1CSProof if ns is PORT else jbp.R1CSProof
    v.verify(proof_cls.from_bytes(blob), g, h, ns.gens("G", 64),
             ns.gens("H", 64))


@pytest.fixture(scope="module")
def preimages():
    """The port's proof (CPU, 128 generators) and the JAX package's native
    `Prover._prove` proof (64 generators) of the three statements."""
    port = _prove_preimages(PORT, lambda p, G, H: p.prove(G, H), 128,
                            device="cpu")
    with _native():
        jax_ = _prove_preimages(JAX, lambda p, G, H: p._prove(G, H), 64)
    return {"port": port, "jax": jax_}


def test_preimage_proof_bytes_match_jax_package(preimages):
    """Byte-identical, though the port was given 128 generators and the
    JAX package 64: the proof reads only the first n = 64."""
    assert preimages["port"][0] == preimages["jax"][0]
    assert [c.to_bytes() for cs in preimages["port"][1] for c in cs] == \
        [c.to_bytes() for cs in preimages["jax"][1] for c in cs]


def test_port_verifier_accepts_jax_preimage_proof(preimages):
    blob = preimages["jax"][0]
    _, comms, images = preimages["port"]
    _verify_preimages(PORT, blob, comms, images, device="cpu")


def test_jax_verifier_accepts_port_preimage_proof(preimages):
    blob, _, _ = preimages["port"]
    _, comms, images = preimages["jax"]
    with _native():
        _verify_preimages(JAX, blob, comms, images)


def test_port_verifier_rejects_wrong_images(preimages):
    blob, comms, images = preimages["port"]
    with pytest.raises(VerificationError):
        _verify_preimages(PORT, blob, comms, images, bump=True,
                          device="cpu")


def test_entry_points_default_to_the_card():
    """The batched hashes and the one-shot preimage proofs run on "cuda"
    unless asked: without a card (as here) they raise instead of running
    on the CPU."""
    import inspect
    fns = [pd.poseidon_permutation_batch, pd.poseidon_hash_2_batch,
           pd.poseidon_hash_4_batch, pd.poseidon_hash_8_batch]
    fns += [getattr(ph, f"{kind}_proof_of_knowledge_of_preimage_of_"
                        f"Poseidon_{a}")
            for kind in ("gen", "verify") for a in (2, 4, 8)]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        params = _params(PORT, 5, SCHEDULES[5])
        with pytest.raises((RuntimeError, AssertionError)):
            pd.poseidon_hash_4_batch([[PORT.Scalar(1)] * 4] * 8, params,
                                     "quint")

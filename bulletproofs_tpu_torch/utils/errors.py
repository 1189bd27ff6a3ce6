"""Error types of the port: its own copy of the part of
`bulletproofs_tpu/utils/errors.py` that the IPA, the R1CS prover and
verifier, the gadgets and the sparse Merkle trees' hash store raise (the
Rust reference's `R1CSError` enum, `src/errors.rs:7-28`, and its two
checking macros, `errors.rs:32-55`)."""


class R1CSError(Exception):
    """Base error for proving/verifying a constraint system."""


class InvalidGeneratorsLength(R1CSError):
    pass


class VerificationError(R1CSError):
    pass


class FormatError(R1CSError):
    pass


class MissingAssignment(R1CSError):
    pass


class GadgetError(R1CSError):
    def __init__(self, description: str):
        super().__init__(description)
        self.description = description


class HashNotFoundInDB(R1CSError):
    def __init__(self, hash_bytes):
        super().__init__(f"hash not found in DB: {bytes(hash_bytes).hex()}")
        self.hash = bytes(hash_bytes)


def check_for_randomness_or_rng(randomness, rng):
    """At least one source of blinding randomness (`errors.rs:32-43`)."""
    if randomness is None and rng is None:
        raise GadgetError("Since randomness is None, provide rng")


def check_for_input_and_randomness_length(inputs, randomness, expected):
    """As many inputs as blindings, `expected` of each (`errors.rs:45-55`)."""
    if len(inputs) != expected or len(randomness) != expected:
        raise GadgetError(
            f"Both input and randomness should be of the same size {expected} "
            f"but input size is {len(inputs)} and randomness size is "
            f"{len(randomness)}")

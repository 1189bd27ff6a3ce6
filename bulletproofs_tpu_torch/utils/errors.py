"""Error types of the port: its own copy of the part of
`bulletproofs_tpu/utils/errors.py` that the IPA, the R1CS prover and
verifier and the bound-check gadget raise (the Rust reference's `R1CSError`
enum, `src/errors.rs:7-28`, and its `check_for_randomness_or_rng` macro,
`errors.rs:32-43`)."""


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


def check_for_randomness_or_rng(randomness, rng):
    """At least one source of blinding randomness (`errors.rs:32-43`)."""
    if randomness is None and rng is None:
        raise GadgetError("Since randomness is None, provide rng")

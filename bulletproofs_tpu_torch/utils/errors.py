"""Error types of the port: its own copy of the part of
`bulletproofs_tpu/utils/errors.py` that the IPA raises (the Rust
reference's `R1CSError` enum, `src/errors.rs:7-28`)."""


class R1CSError(Exception):
    """Base error for proving/verifying a constraint system."""


class VerificationError(R1CSError):
    pass

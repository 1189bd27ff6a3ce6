"""Node storage of the sparse Merkle trees (the Rust reference's
`src/utils/hash_db.rs:4-35`): the port's own copy of
`bulletproofs_tpu/utils/hash_db.py`."""

from .errors import HashNotFoundInDB


class HashDb:
    """Abstract hash -> value store."""

    def insert(self, hash_bytes: bytes, value):
        raise NotImplementedError

    def get(self, hash_bytes: bytes):
        raise NotImplementedError


class InMemoryHashDb(HashDb):
    def __init__(self):
        self.db = {}

    def insert(self, hash_bytes: bytes, value):
        self.db[bytes(hash_bytes)] = value

    def get(self, hash_bytes: bytes):
        try:
            return self.db[bytes(hash_bytes)]
        except KeyError:
            raise HashNotFoundInDB(hash_bytes) from None

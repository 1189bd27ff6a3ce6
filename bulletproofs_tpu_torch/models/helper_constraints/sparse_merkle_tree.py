"""The native sparse Merkle tree over a HashDb, for any power-of-two arity:
what the port's 4-ary and 8-ary trees share (the Rust reference's
`VanillaSparseMerkleTree_4`, `sparse_merkle_tree_4_ary.rs:48-209`, and
`VanillaSparseMerkleTree_8`, `sparse_merkle_tree_8_ary.rs:48-225`; the JAX
package keeps one copy in each of its two modules).

A node's children are stored under the bytes of its hash; a leaf index is
read as `depth` big-endian base-`arity` digits, root to leaf.
"""

from ...config import curve
from ...ops.field_host import Scalar
from ...utils.errors import R1CSError
from . import get_bit_count, get_byte_size


def get_base_repr(scalar: Scalar, num_digits: int, base: int):
    """Big-endian base-`base` digits of `scalar`, exactly `num_digits` of
    them (`sparse_merkle_tree_4_ary.rs:21-43`,
    `sparse_merkle_tree_8_ary.rs:23-45`)."""
    byte_size = get_byte_size(num_digits, base)
    if byte_size > curve().modbytes:
        raise R1CSError(
            f"limit_bytes cannot be more than {curve().modbytes} "
            f"but found {byte_size}")
    bits = get_bit_count(1, base)
    s = int(scalar)
    digits = []
    while len(digits) != num_digits and s != 0:
        digits.append(s & (base - 1))
        s >>= bits
    while len(digits) != num_digits:
        digits.append(0)
    digits.reverse()
    return digits


class VanillaSparseMerkleTree:
    """The tree of one arity: a subclass sets `arity`, the host hash
    `_hash(children)` and the batched device hash
    `_hash_batch(child_lists, device)`.  `device` is where `batch_update`
    hashes, the card unless the caller passes another."""

    arity = None

    def __init__(self, hash_params, depth: int, hash_db, device="cuda"):
        self.depth = depth
        self.hash_params = hash_params
        self.device = device
        empty = [Scalar.zero()]
        for i in range(1, depth + 1):
            children = [empty[i - 1]] * self.arity
            new = self._hash(children)
            hash_db.insert(new.to_bytes(), list(children))
            empty.append(new)
        self.root = empty[depth]

    def _hash(self, children):
        raise NotImplementedError

    def _hash_batch(self, child_lists, device):
        raise NotImplementedError

    def update(self, idx: Scalar, val: Scalar, hash_db) -> Scalar:
        proof = []
        self.get(idx, proof, hash_db)
        path = self.leaf_index_to_path(idx, self.depth)
        path.reverse()
        cur_val = val
        for d in path:
            side = list(proof.pop())
            side.insert(d, cur_val)
            h = self._hash(side)
            hash_db.insert(h.to_bytes(), side)
            cur_val = h
        self.root = cur_val
        return cur_val

    def batch_update(self, pairs, hash_db) -> Scalar:
        """Apply [(idx, val), ...] and return the new root.

        The final root and node set of sequential `update` calls (interior
        hashes depend only on the final leaf values, and the last write to
        an index wins), but each level's hashes run as one batch on
        `self.device`, so k updates cost `depth` batched rounds instead of
        k * depth serial permutations.  A level of fewer than 8 parents
        hashes on the host, as in the JAX package.  Intermediate roots are
        not formed."""
        if not pairs:
            return self.root
        pending = {}
        for idx, val in pairs:
            pending[tuple(self.leaf_index_to_path(idx, self.depth))] = val
        # one descent over the union of the touched prefixes
        prefixes = sorted({p[:k] for p in pending for k in range(len(p))},
                          key=len)
        node_at = {(): self.root}
        pre_children = {}
        for pre in prefixes:
            ch = list(hash_db.get(node_at[pre].to_bytes()))
            pre_children[pre] = ch
            for d in range(self.arity):
                node_at[pre + (d,)] = ch[d]
        for _level in range(self.depth, 0, -1):
            groups = {}
            for path, val in pending.items():
                groups.setdefault(path[:-1], {})[path[-1]] = val
            parents = sorted(groups)
            child_lists = []
            for ppath in parents:
                children = list(pre_children[ppath])
                for d, v in groups[ppath].items():
                    children[d] = v
                child_lists.append(children)
            if len(child_lists) >= 8:
                hashes = self._hash_batch(child_lists, self.device)
            else:
                hashes = [self._hash(cl) for cl in child_lists]
            pending = {}
            for ppath, cl, h in zip(parents, child_lists, hashes):
                hash_db.insert(h.to_bytes(), cl)
                pending[ppath] = h
        self.root = pending[()]
        return self.root

    def get(self, idx: Scalar, proof, hash_db) -> Scalar:
        """Walk root to leaf; if `proof` is a list, append the arity - 1
        sibling nodes of each level to it."""
        path = self.leaf_index_to_path(idx, self.depth)
        cur_node = self.root
        for d in path:
            children = hash_db.get(cur_node.to_bytes())
            if proof is not None:
                proof.append([c for i, c in enumerate(children) if i != d])
            cur_node = children[d]
        return cur_node

    def verify_proof(self, idx: Scalar, val: Scalar, proof, root=None):
        path = self.leaf_index_to_path(idx, self.depth)
        path.reverse()
        cur_val = val
        for i, d in enumerate(path):
            p = list(proof[self.depth - 1 - i])
            p.insert(d, cur_val)
            cur_val = self._hash(p)
        target = root if root is not None else self.root
        return cur_val == target

    @classmethod
    def leaf_index_to_path(cls, idx: Scalar, depth: int):
        return get_base_repr(idx, depth, cls.arity)


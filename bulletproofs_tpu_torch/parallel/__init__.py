"""Sharding over a mesh of devices driven by one process: the sharded MSM
and the sharded prover (the port of `bulletproofs_tpu/parallel/`).

The n-axis of points and scalars is cut into one shard per mesh device;
each shard runs its own Pippenger bucket pass, and the bucket arrays are
reduced by a butterfly of complete EC adds.  A mesh may repeat a device,
so four shards of one card run every exchange on that card; with several
cards the exchanges are peer copies between them.
"""

from .sharded_msm import (Mesh, make_mesh, make_mesh_2d, msm_sharded,
                          msm_sharded_2d)
from .sharded_prover import create_ipp_sharded, msm_multi_sharded, \
    prove_sharded

__all__ = ["Mesh", "create_ipp_sharded", "make_mesh", "make_mesh_2d",
           "msm_multi_sharded", "msm_sharded", "msm_sharded_2d",
           "prove_sharded"]

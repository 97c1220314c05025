"""The batched proximity pipeline (BASELINE config[3]) and its distribution
over a mesh of ranks (``torch.distributed``).

Parallelism, as in the reference (SURVEY.md §2):
  dp    -- ciphertext-batch data parallel (independent proximity checks)
  limb  -- RNS-limb tensor parallel (NTT and pointwise ops are limb-local)
  coeff -- polynomial-coefficient parallel (``ntt_dist``: an exchange between
           the coefficient and the row layouts around the transforms)
"""

from .behz_dist import DistMultiplier
from .mesh import ct_sharding, ct_spec, gather, make_mesh, shard
from .ntt_dist import make_dist_ntt, pointwise_mul_dist
from .pipeline import (
    bf_probe,
    blinded_keys,
    build_batched_pipeline,
    build_packed_pipeline,
    build_packed_pipeline_bf,
    build_pipeline_filter,
    make_batch_inputs,
    make_packed_inputs,
)

__all__ = [
    "make_mesh",
    "ct_spec",
    "ct_sharding",
    "shard",
    "gather",
    "make_dist_ntt",
    "pointwise_mul_dist",
    "DistMultiplier",
    "build_batched_pipeline",
    "build_packed_pipeline",
    "build_packed_pipeline_bf",
    "blinded_keys",
    "bf_probe",
    "make_batch_inputs",
    "make_packed_inputs",
]

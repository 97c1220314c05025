"""The batched proximity pipeline (BASELINE config[3]) on one device."""

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
    "build_batched_pipeline",
    "build_packed_pipeline",
    "build_packed_pipeline_bf",
    "blinded_keys",
    "bf_probe",
    "make_batch_inputs",
    "make_packed_inputs",
]

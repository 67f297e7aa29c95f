"""Multi-sequence full-head reconstruction."""

from omfs4d_torch.headrecon.pipeline import (  # noqa: F401
    build_canonical_head,
    evaluate_head_coverage,
    evaluate_multi_coverage,
    fit_shared_shape,
    ingest_sequences,
    register_sequences,
)

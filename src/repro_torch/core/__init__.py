"""The paper's system on PyTorch: fields, weights, clustering, the index,
the engines and the typed API (counterpart of :mod:`repro.core`)."""

from .api import (
    ExecShape,
    Hit,
    Retriever,
    SearchRequest,
    SearchResponse,
    decompose_scores,
    exec_shape,
    plan_probes,
)
from .cluster import (
    CLUSTERERS,
    ClusteringResult,
    FPFClusterer,
    FusedFPFClusterer,
    assign_refine,
    assign_to_centers,
    assign_to_centers_multi,
    available_clusterers,
    fpf_centers,
    get_clusterer,
    pick_clusterer,
    register_clusterer,
)
from .engine import (
    BACKENDS,
    available_backends,
    get_engine,
    pick_backend,
    register_backend,
    split_probes,
    sweep_probes,
)
from .fields import FieldSpec, concat_fields, normalize_fields, split_fields
from .index import (
    SUPPORTED_PACK_DTYPES,
    ClusterPruneIndex,
    CorruptIndexError,
    pack_buckets,
    pack_buckets_major,
    validate_pack_dtype,
)
from .metrics import (
    brute_force_bottomk,
    brute_force_topk,
    competitive_recall,
    normalized_aggregate_goodness,
    quality_report,
    recall_fraction,
)
from .weights import (
    aggregate_similarity,
    expand_weights,
    validate_weights,
    weighted_query,
)

__all__ = [
    "BACKENDS", "CLUSTERERS", "ClusterPruneIndex", "ClusteringResult",
    "CorruptIndexError", "ExecShape", "FPFClusterer", "FieldSpec",
    "FusedFPFClusterer", "Hit", "Retriever", "SUPPORTED_PACK_DTYPES",
    "SearchRequest", "SearchResponse", "aggregate_similarity",
    "assign_refine", "assign_to_centers", "assign_to_centers_multi",
    "available_backends", "available_clusterers", "brute_force_bottomk",
    "brute_force_topk", "competitive_recall", "concat_fields",
    "decompose_scores", "exec_shape", "expand_weights", "fpf_centers",
    "get_clusterer", "get_engine", "normalize_fields",
    "normalized_aggregate_goodness", "pack_buckets", "pack_buckets_major",
    "pick_backend", "pick_clusterer", "plan_probes", "quality_report",
    "recall_fraction", "register_backend", "register_clusterer",
    "split_fields", "split_probes", "sweep_probes", "validate_pack_dtype",
    "validate_weights", "weighted_query",
]

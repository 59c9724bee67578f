"""The paper's system on PyTorch: fields, weights, clustering, the index,
the engines (``reference``, ``fused``, ``sharded``) and the typed API
(counterpart of :mod:`repro.core`). ``distributed`` is the doc-sharded
substrate of the ``sharded`` backend; as in the reference, its functions
are imported from the module itself, not re-exported here."""

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
from .calibrate import ProbeLadder, calibrate_index, isotonic_fit
from .celldec import CellDecIndex, region_of, region_weights
from .cluster import (
    CLUSTERERS,
    Clusterer,
    ClusteringResult,
    FPFClusterer,
    FusedFPFClusterer,
    KMeansClusterer,
    RandomLeaderClusterer,
    assign_refine,
    assign_to_centers,
    assign_to_centers_multi,
    available_clusterers,
    fpf_centers,
    fpf_cluster,
    get_clusterer,
    kmeans_cluster,
    pick_clusterer,
    random_leader_cluster,
    register_clusterer,
)
from .engine import (
    BACKENDS,
    SearchEngine,
    available_backends,
    get_engine,
    pick_backend,
    register_backend,
    split_probes,
    sweep_probes,
)
from .fields import FieldSpec, concat_fields, normalize_fields, split_fields
from .index import (
    LADDER_DRIFT_THRESHOLD,
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
    cosine_distance,
    expand_weights,
    nwd,
    validate_weights,
    weighted_query,
)

__all__ = [
    "BACKENDS", "CLUSTERERS", "CellDecIndex", "ClusterPruneIndex",
    "Clusterer", "ClusteringResult", "CorruptIndexError", "ExecShape",
    "FPFClusterer", "FieldSpec", "FusedFPFClusterer", "Hit",
    "KMeansClusterer", "LADDER_DRIFT_THRESHOLD", "ProbeLadder",
    "RandomLeaderClusterer", "Retriever", "SUPPORTED_PACK_DTYPES",
    "SearchEngine", "SearchRequest", "SearchResponse",
    "aggregate_similarity", "assign_refine", "assign_to_centers",
    "assign_to_centers_multi", "available_backends", "available_clusterers",
    "brute_force_bottomk", "brute_force_topk", "calibrate_index",
    "competitive_recall", "concat_fields", "cosine_distance",
    "decompose_scores", "exec_shape", "expand_weights", "fpf_centers",
    "fpf_cluster", "get_clusterer", "get_engine", "isotonic_fit",
    "kmeans_cluster", "normalize_fields", "normalized_aggregate_goodness",
    "nwd", "pack_buckets", "pack_buckets_major", "pick_backend",
    "pick_clusterer", "plan_probes", "quality_report",
    "random_leader_cluster", "recall_fraction", "region_of",
    "region_weights", "register_backend", "register_clusterer",
    "split_fields", "split_probes", "sweep_probes", "validate_pack_dtype",
    "validate_weights", "weighted_query",
]

"""repro_torch.core — the paper's H-matrix algorithms in PyTorch.

Public API:
    halton, get_kernel, dense_kernel_matrix, sinusoid_targets   (geometry)
    morton_encode, morton_order, morton_sort                    (Z-order, §4.4)
    build_cluster_tree, permute_to_tree, permute_from_tree      (CBC, §2.1)
    build_block_tree, HMatrixPlan                               (block tree)
    aca_fixed_rank, batched_aca, aca_adaptive                   (ACA, §2.4)
    FactorStore, effective_ranks, pad_adaptive, recompress_store,
    RecompressReport                                            (factor storage, memory tier)
    build_hmatrix, make_apply, make_matvec, HMatrix,
    diagonal_blocks, dense_matvec_oracle                        (assembly + apply)
    build_hmatrix_device, build_hmatrix_device_report,
    BuildReport, compute_factors_device, eval_dense_leaves      (device build)
"""
from .geometry import (dense_kernel_matrix, gaussian_kernel, get_kernel, halton,
                       matern_kernel, sinusoid_targets)
from .morton import morton_encode, morton_order, morton_sort
from .clustering import ClusterTree, build_cluster_tree, permute_from_tree, permute_to_tree
from .admissibility import admissible, diam, dist
from .block_tree import HMatrixPlan, build_block_tree
from .aca import aca_adaptive, aca_fixed_rank, batched_aca
from .factor_store import (FactorStore, RecompressReport, effective_ranks, pad_adaptive,
                           recompress_store)
from .hmatrix import (HMatrix, apply_in_tree_order, build_hmatrix, compute_factors,
                      dense_matvec_oracle, diagonal_blocks, make_apply, make_matvec)
from .build_device import (BuildReport, build_hmatrix_device, build_hmatrix_device_report,
                           compute_factors_device, eval_dense_leaves)

__all__ = [
    "halton", "get_kernel", "dense_kernel_matrix", "gaussian_kernel",
    "matern_kernel", "sinusoid_targets",
    "morton_encode", "morton_order", "morton_sort",
    "ClusterTree", "build_cluster_tree", "permute_to_tree", "permute_from_tree",
    "admissible", "diam", "dist",
    "HMatrixPlan", "build_block_tree",
    "aca_fixed_rank", "batched_aca", "aca_adaptive",
    "FactorStore", "effective_ranks", "pad_adaptive", "recompress_store", "RecompressReport",
    "HMatrix", "build_hmatrix", "make_apply", "make_matvec",
    "dense_matvec_oracle", "compute_factors", "diagonal_blocks",
    "apply_in_tree_order",
    "BuildReport", "build_hmatrix_device", "build_hmatrix_device_report",
    "compute_factors_device", "eval_dense_leaves",
]

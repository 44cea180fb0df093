"""Operations and bytes of one dense kNN call (K1 grouped, K2 exact) by
shape, as chip_smoke.py's `_knn_bound` counts them: each query-database
pair costs OPS_PER_PAIR float32 operations (the expanded-form distance and
its compare); each query and database point is read once (12 B, plus 1 B
of validity for the database) and each neighbour written once (8 B:
distance and index)."""
from vilbench.rooflines import peaks

OPS_PER_PAIR = 8


def bound_s(nq: int, nd: int, k: int) -> float:
    """The least seconds the H100 could take for the call: the larger of
    the operations at the FP32 peak and the bytes at the HBM peak."""
    t_ops = nq * nd * OPS_PER_PAIR / peaks.FP32_FLOPS
    t_bytes = (nq * 12 + nd * 13 + nq * k * 8) / peaks.HBM_BYTES_PER_S
    return max(t_ops, t_bytes)


KERNELS = ("knn_dense_kernel", "knn_merge_kernel")


def is_kernel(name: str) -> bool:
    """Whether a device operation of the trace is a dense kNN kernel
    (csrc/knn.cu: the search, and the merge of a split database)."""
    return any(k in name for k in KERNELS)

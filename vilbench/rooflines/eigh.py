"""Operations and bytes of one symmetric n x n eigendecomposition, as
chip_smoke.py's `_eigh_bound` counts them: 9 n^3 float32 operations, the
matrix read and the eigenvectors written (2 n^2 x 4 B)."""
from vilbench.rooflines import peaks


def bound_s(n: int) -> float:
    t_ops = 9 * n ** 3 / peaks.FP32_FLOPS
    t_bytes = 2 * n * n * 4 / peaks.HBM_BYTES_PER_S
    return max(t_ops, t_bytes)

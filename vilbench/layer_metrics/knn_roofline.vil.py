"""Share of their roofline that the dense kNN kernels (K1, K2) reach in the
traced sub-window: the summed bound of the calls (their shapes counted by
the port's wrappers, ops/cuda/knn_cuda.py) over the summed device time of
csrc/knn.cu's dense search and merge kernels (by kernel name)."""
from vilbench.rooflines import knn


def read(rec):
    tr = rec.trace
    if tr is None or not tr.knn_calls:
        return None
    t = sum(s for name, (_, s) in tr.kernels.items() if knn.is_kernel(name))
    if t <= 0:
        return None
    bound = sum(n * knn.bound_s(*shape) for shape, n in tr.knn_calls.items())
    return 100.0 * bound / t

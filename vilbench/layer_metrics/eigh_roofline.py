"""Share of their roofline that the marginalization's eigensolver kernels
(csrc/eigh.cu: hhql_eigh_kernel on the prior, jacobi_warp_kernel on the
Schur block) reach in the traced sub-window: each launch's bound at the
size the configuration's `eigh_sizes` gives it, over the kernels' device
time."""
from vilbench.rooflines import eigh


def read(rec):
    tr = rec.trace
    sizes = rec.config.get("eigh_sizes", {})
    if tr is None:
        return None
    bound = t = 0.0
    for name, (count, secs) in tr.kernels.items():
        for kernel, n in sizes.items():
            if kernel != "why" and kernel in name:
                bound += count * eigh.bound_s(n)
                t += secs
    return 100.0 * bound / t if t > 0 else None

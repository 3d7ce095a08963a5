"""``gemm_ms_per_step``: device ms a step of the library's matrix-product
kernels (cuBLAS, CUTLASS), picked by kernel name, in the profiled
sub-window; the program's own kernels are not among them.  cuBLAS names
some of its f32 GEMM kernels ``Kernel2`` (on the H100 with torch 2.11:
with the ``*gemm*`` kernels they make up the ``aten::mm`` time of an
eager profile of the same step)."""

LIBRARY = ("gemm", "cutlass", "xmma", "cublas", "gemv", "splitkreduce")
CUBLAS_NAMES = ("Kernel2",)


def _library(name):
    low = name.lower()
    return name in CUBLAS_NAMES or any(key in low for key in LIBRARY)


def read(run):
    if not run.trace.kernels or not run.trace.steps:
        return None
    return run.trace.kernel_seconds(_library) * 1e3 / run.trace.steps

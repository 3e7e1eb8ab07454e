"""matmul_ms_per_round: device ms a round in the model's matrix products and
convolutions (cuBLAS, cuDNN and CUTLASS kernels, by the name patterns
below), over the kernels the replayed rounds ran.  Read from the device
trace; moves rounds_per_s (as
``<name>.lm``, rounds_per_s.lm in the decoder cells)."""

#: substrings of the names of matrix-product and convolution kernels
PATTERNS = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "conv", "implicit_convolve",
            "winograd", "fft", "wgrad", "dgrad", "fprop", "cudnn", "sm90_", "sm80_",
            "ampere_", "volta_", "turing_", "s1688", "s16816", "h1688", "h16816",
            "splitk", "splitK", "bmm", "dot_kernel", "cublas")


def is_matmul(name: str) -> bool:
    low = name.lower()
    return any(p.lower() in low for p in PATTERNS)


def read(view):
    ks = view.graph_kernels()
    if not ks or view.rounds <= 0:
        return None
    return sum(k.end - k.start for k in ks if is_matmul(k.name)) * 1e-6 / view.rounds

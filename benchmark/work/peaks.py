"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its
700 W limit."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# fp32 storage: TF32 tensor cores are the fastest rate any fp32 kernel runs
# at, so no share read against it can pass 100%
TF32_FLOPS = 495e12


def flops_for(dtype: str) -> float:
    return BF16_FLOPS if dtype == "bfloat16" else TF32_FLOPS

"""Peak rates of one NVIDIA H100 SXM (80 GB HBM3), the yardstick's constants.

From NVIDIA's H100 Tensor Core GPU data sheet, SXM part, dense rates
(without sparsity), at the full 700 W power limit. A card set below that
limit runs slower under load, so every result names the card's limit
beside its numbers. The values are the ones ``roofline/analysis.py`` of the
port carries; they are copied here so that no change to the program can
move the yardstick.
"""

BF16_FLOPS = 989.4e12    # bf16 / fp16 tensor cores, dense
TF32_FLOPS = 494.7e12    # f32 operands on the tensor cores (TF32), dense
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int32": 4, "int64": 8}


def matmul_peak(dtype: str) -> float:
    """The tensor-core peak for operands of ``dtype``: bf16 and fp16 at the
    bf16 rate, f32 at the TF32 rate (the fastest an f32 product can go)."""
    return BF16_FLOPS if dtype in ("bfloat16", "float16") else TF32_FLOPS

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit)."""

BF16_FLOPS = 989e12   # bf16 and fp16 tensor cores
TF32_FLOPS = 495e12   # TF32 tensor cores: the fastest rate of an f32-accurate product
HBM_BYTES = 3.35e12   # HBM3 bytes a second

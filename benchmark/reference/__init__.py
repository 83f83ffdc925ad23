"""The plain reference of the benchmark's configurations: the GAOT-3D forward
(MAGNO encoder with the statistical geoembed, U-ViT processor, MAGNO
decoder), its masked-MSE training step with AdamW, the radius graph and the
attention-dropout bit generator, in plain PyTorch.

It imports nothing of the program under test. It reads the configuration
file, the inputs the benchmark makes and a state dict of initial weights;
everything the program derives from those (edge slots, degree sections,
packed kernel weights, dropout bits) it works out again.

Precision follows the configuration: float32 with TF32 off everywhere,
except where the configuration states bfloat16 (the GNO kernel MLPs'
operands under `kernel_dtype: bfloat16`; attention's q, k, v, its
probabilities before the product with v, and its output under
`attention_dtype: bfloat16`).
"""

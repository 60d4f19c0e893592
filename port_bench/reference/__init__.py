"""The plain reference of the segmentation pipeline (BLIP-ITM GradCAM,
salience drop, pooling, threshold, bucket upsample, blur and DenseCRF):
plain PyTorch in float32 with TF32 off, one image at a time.

It reads a LAVIS BLIP-ITM state dict and the benchmark's raw inputs, and
works out everything else itself. It imports nothing of the system under
test: neither ``jax`` nor either package of the repository.

``precision.Rounding`` puts its products, kernel codes and state into a
lower format, which makes it the control that the comparison has to
refuse.
"""

"""SAM-style point-prompted segmentation (the 22_* stages' model), in
PyTorch: ViT image encoder (windowed attention, decomposed relative
positions, conv neck), random-Fourier prompt encoder and two-way
transformer mask decoder, as the JAX package's ``models/sam``."""

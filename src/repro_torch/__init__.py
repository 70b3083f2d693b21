"""PyTorch/CUDA port of the HLoRA system (see README.md)."""

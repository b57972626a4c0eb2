"""Hand-written CUDA kernels (``csrc/``), their launchers and plain versions."""

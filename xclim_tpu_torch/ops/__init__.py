"""Device ops: the segment engine, the sort quantile and the hand-written
CUDA kernels with their plain PyTorch twins."""

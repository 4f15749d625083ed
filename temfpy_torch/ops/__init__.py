"""Device operations of temfpy_torch: plain PyTorch linear algebra
(:mod:`.linalg`) and the hand-written CUDA kernels with their twins
(:mod:`.kernels`, built by :mod:`._build`)."""

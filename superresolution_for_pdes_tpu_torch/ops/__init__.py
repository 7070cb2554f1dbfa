"""Array operations: grid, align-corners resize, 5-point stencil, the
hand-written CUDA stencil kernels and SwinIR's window-attention kernels."""

"""Work per launch of the hand-written kernels, one module per kernel."""

"""The benchmark's plain reference: what a frame and a training step of
3D Gaussian Splatting compute, in plain PyTorch, from the inputs the
benchmark made.  It imports nothing of the program under test."""

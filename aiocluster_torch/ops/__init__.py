"""The gossip round (plain PyTorch), its random draws, and the wrappers of
the hand-written CUDA kernels in csrc/."""

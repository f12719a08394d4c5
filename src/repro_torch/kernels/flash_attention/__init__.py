"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``, ``kernel.py``), its plain PyTorch version
(``ref.py``) and the dispatching entry point (``ops.attention``)."""

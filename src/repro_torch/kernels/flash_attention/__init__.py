"""Flash attention: the hand-written CUDA forward (with its log-sum-exp)
and backward (``csrc/flash_attention.cu``, ``kernel.py``), their plain
PyTorch versions (``ref.py``; the reference's differentiable paths in
``blocked.py``) and the dispatching entry point (``ops.attention``)."""

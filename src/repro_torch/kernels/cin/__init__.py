"""The xDeepFM CIN layer: the hand-written CUDA kernel (``csrc/cin.cu``,
``kernel.py``), its plain PyTorch version (``ref.py``), the dispatching
entry points (``ops.cin_layer``, ``ops.cin``) and the shared case table and
float32 rule (``cases.py``)."""

"""GCN message passing, ``Y[n] = sum over in-edges e of coeff_e X[src_e]``:
the hand-written CUDA kernel (``csrc/segment_mm.cu``, ``kernel.py``), its
plain PyTorch version (``ref.py``), the destination-sorted CSR layout and
the dispatching entry points (``ops.py``), and the shared case table and
float32 rule (``cases.py``)."""

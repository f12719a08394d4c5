"""PyTorch + CUDA port of the diameter-approximation engine.

A sibling of ``repro`` (the JAX reference) with the same layout: ``graph/``
(host edge lists, generators, segment tuple-min), ``kernels/edge_relax/``
(the hand-written Hopper relax kernel beside its plain PyTorch version),
``core/`` (engine state, Δ-growing, backends, the CLUSTER stage loop,
quotient + solve, sessions and estimators) and ``launch/`` (the CLI).

The package imports ``torch``, numpy and scipy only. Entry points default
to ``device="cuda"`` and raise when no GPU is present; pass
``device="cpu"`` to run the plain PyTorch path.
"""

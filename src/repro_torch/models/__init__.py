"""Models of the port: the dense decoder-only transformer (LM slice) and
xDeepFM serving (recsys slice)."""

"""Plain PyTorch references that the program is tested against: no kernel
of the port (``ops``), no cache, no batching tricks, float32."""

"""The live chain halves and the multi-stream serving engine."""

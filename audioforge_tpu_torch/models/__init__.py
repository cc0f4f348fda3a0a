"""RNNoise and the block-cadence VAD auto-gate controller."""

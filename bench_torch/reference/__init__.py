"""The benchmark's plain reference: a frozen copy of the port's serving step
(``audioforge_tpu_torch``'s ``runtime/serving.py`` pure functions, the live
chain, the DSP ops, Silero VAD, RNNoise and DeepFilterNet3) with every
kernel launch taken out, so each stage runs its plain PyTorch twin. It runs
on the CPU and imports nothing of the program; the module docstrings are the
port's as copied, and where they speak of a CUDA kernel, this copy runs the
plain twin instead. Later changes to the program leave it as it is: it is
what the benchmark's check holds the program's output to."""

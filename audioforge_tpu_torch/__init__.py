"""audioforge_tpu_torch — the PyTorch + CUDA port of audioforge_tpu.

The single-stream live engine (:class:`AudioProcessor`: host threads around
three CUDA graphs captured once per topology, the suppressor engine and the
streaming VAD), the multi-stream serving step (in-step Silero VAD, live chain front half,
RNNoise or DeepFilterNet3, back half) and the offline chain with its
simulators (``runtime/chain.py``, ``api.py``) run on an NVIDIA GPU, with the
per-sample recurrences and the models' per-stream element work in
hand-written CUDA kernels (``csrc/``, built with ``nvcc`` at first use into
``build/audioforge_tpu_torch/``). On a CPU tensor every kernel wrapper runs
its plain PyTorch twin instead. The JAX package stays the reference; this
package imports neither ``jax`` nor ``audioforge_tpu``.
"""

import torch

# f32 matmuls and the pitch correlation (a grouped conv) in full f32: the
# reference budgets 1e-3 on model activations and 1e-4 RMS on audio
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

# the reference package root's flag for its optional native core; the
# compute core here is this package, so it is always available
CORE_AVAILABLE = True

from .runtime.processor import (  # noqa: E402 — after the backend flags
    AudioProcessor,
    list_input_devices,
    list_output_devices,
    register_virtual_input,
    register_virtual_output,
)

__all__ = ["CORE_AVAILABLE", "AudioProcessor", "list_input_devices", "list_output_devices",
           "register_virtual_input", "register_virtual_output"]

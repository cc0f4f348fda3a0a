"""audioforge_tpu_torch — the PyTorch + CUDA port of audioforge_tpu.

The single-stream live engine (:class:`AudioProcessor`: host threads around
three CUDA graphs captured once per topology, the suppressor engine and the
streaming VAD), the multi-stream serving step (in-step Silero VAD, live chain front half,
RNNoise or DeepFilterNet3, back half) and the offline chain with its
simulators (``runtime/chain.py``, ``api.py``) run on an NVIDIA GPU, the
serving engine and the candidate sweep also sharded over several
(``parallel/``), with the
per-sample recurrences and the models' per-stream element work in
hand-written CUDA kernels (``csrc/``, built with ``nvcc`` at first use into
``build/audioforge_tpu_torch/``). On a CPU tensor every kernel wrapper runs
its plain PyTorch twin instead. The preset and configuration layer
(``config/``, ``runtime/preset_io.py``) reads the same files as the JAX
package. The root's names are the reference root's. The JAX package stays
the reference; this package imports neither ``jax`` nor ``audioforge_tpu``.
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

from .api import (  # noqa: E402,F401 — after the backend flags
    compressor_pumping_score,
    eq_magnitude_response,
    eq_magnitude_response_v2,
    measure_integrated_loudness,
    simulate_auto_eq_chain,
    simulate_auto_makeup_control,
    simulate_eq_v2,
    simulate_gate_suppressor_order,
)
from .ops.resample import (  # noqa: E402,F401
    product_resampler_configuration,
    simulate_product_resampler,
)
from .models.silero import analyze_vad_probabilities  # noqa: E402,F401
from .models.dfn3 import configure_deepfilter_runtime_paths  # noqa: E402,F401
from .runtime.processor import (  # noqa: E402,F401
    AudioProcessor,
    DeviceInfo,
    list_input_devices,
    list_output_devices,
    register_virtual_input,
    register_virtual_output,
)
from .config import (  # noqa: E402,F401
    BUILTIN_PRESETS,
    Preset,
    list_presets,
    load_preset,
    save_preset,
)

# the reference package root's names (`audioforge_tpu/__init__.py`)
__all__ = [
    "CORE_AVAILABLE",
    "AudioProcessor",
    "BUILTIN_PRESETS",
    "DeviceInfo",
    "Preset",
    "analyze_vad_probabilities",
    "list_input_devices",
    "list_output_devices",
    "register_virtual_input",
    "register_virtual_output",
    "compressor_pumping_score",
    "configure_deepfilter_runtime_paths",
    "eq_magnitude_response",
    "eq_magnitude_response_v2",
    "list_presets",
    "load_preset",
    "measure_integrated_loudness",
    "product_resampler_configuration",
    "save_preset",
    "simulate_auto_eq_chain",
    "simulate_auto_makeup_control",
    "simulate_eq_v2",
    "simulate_gate_suppressor_order",
    "simulate_product_resampler",
]

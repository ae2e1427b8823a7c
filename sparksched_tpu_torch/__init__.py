"""sparksched_tpu_torch: the PyTorch/CUDA port of sparksched_tpu.

This slice serves Decima decisions: `serve.SessionStore` over the
sequential engine (`env/`), the Decima policy (`schedulers/`) and the
hand-written NodeEncoder kernel (`kernels/`, `csrc/`). Every entry point
takes `device=` and defaults to the card. The package imports torch and
numpy, never JAX or the JAX package.
"""

from .config import EnvParams, env_params_from_cfg, load, resolve_device  # noqa: F401

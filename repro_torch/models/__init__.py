"""PyTorch model zoo of the port (the dense transformer family so far).

Every model is (param_specs, init, prefill, decode_step) over a flat
``dict[str, Tensor]`` with the JAX package's parameter names, shapes,
dtypes and stacked ``[L, ...]`` layout.
"""

from repro_torch.models.api import build_model  # noqa: F401

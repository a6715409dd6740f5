"""Architecture configs: one module per ported architecture.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests.
The schema (``base.py``) and each config module are copies of the JAX
package's, so both packages build the same model from the same name.
"""

from __future__ import annotations

import importlib

#: the architectures this package has ported so far (the dense serving slice)
ARCHS = [
    "smollm_135m",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
# published ids use dots (qwen3-1.7b); module names use underscores
_ALIAS.update({a.replace("_", "-").replace("-7b", ".7b"): a for a in ARCHS})


def canonical(arch: str) -> str:
    arch = _ALIAS.get(arch, arch)
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = canonical(arch)
    if name not in ARCHS:
        raise ValueError(f"architecture {arch!r} is not ported yet "
                         f"(ported: {ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()

"""Deterministic fault injection for the serving plane: a copy of
``aios_tpu/faults``. Hot paths call ``faults.point("<name>")``, a no-op
unless a seeded schedule is armed via ``AIOS_TPU_FAULTS`` or
:func:`activate`. See :mod:`aios_tpu_torch.faults.inject` for the catalog,
trigger grammar and determinism contract.
"""

from .inject import (
    MODES,
    POINTS,
    FaultAction,
    InjectedFault,
    activate,
    active,
    deactivate,
    fired,
    install_from_env,
    point,
)

__all__ = [
    "MODES",
    "POINTS",
    "FaultAction",
    "InjectedFault",
    "activate",
    "active",
    "deactivate",
    "fired",
    "install_from_env",
    "point",
]

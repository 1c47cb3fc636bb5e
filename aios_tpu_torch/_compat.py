"""Version-compat shims shared across the package.

``tomllib``: stdlib from Python 3.11; on 3.10 the API-identical ``tomli``
backport (baked into the image) stands in. Import it from here so the
fallback policy lives in ONE place:

    from aios_tpu_torch._compat import tomllib
"""

from __future__ import annotations

try:
    import tomllib
except ImportError:  # Python 3.10
    import tomli as tomllib  # type: ignore[no-redef]

__all__ = ["tomllib"]

"""The check that a run loaded neither JAX nor the JAX package: top-level
module names compared whole (the port's name begins with the JAX
package's)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "sqair_tpu")


def forbidden(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))

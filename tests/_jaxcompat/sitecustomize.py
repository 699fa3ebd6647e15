"""Let the JAX reference package import under jax >= 0.9.

``repro.util`` registers a vmap rule for ``optimization_barrier`` behind a
``prim in batching.primitive_batchers`` guard.  From jax 0.9 on,
``primitive_batchers`` is a write-only ``PrimitiveBatchersProxy`` with no
``__contains__``, so the guard raises ``TypeError`` and ``import repro``
fails.  The proxy stores its rules in ``fancy_primitive_batchers``; giving
it a ``__contains__`` that looks there makes the guard work again (jax 0.9
batches ``optimization_barrier`` natively, so the guard returns early).

The directory holding this file is prepended to ``PYTHONPATH`` by the
repository's root ``conftest.py``, so every Python subprocess the tests
start imports it at interpreter start-up; the test process itself calls
:func:`apply` directly.  Older jax (no proxy class) is left untouched.
"""
from __future__ import annotations


def apply() -> None:
    """Give ``PrimitiveBatchersProxy`` a ``__contains__`` (idempotent)."""
    try:
        from jax._src.interpreters import batching
    except ImportError:         # no jax in this interpreter: nothing to fix
        return
    proxy = getattr(batching, "PrimitiveBatchersProxy", None)
    if proxy is None or "__contains__" in vars(proxy):
        return

    def __contains__(self, prim) -> bool:
        return prim in batching.fancy_primitive_batchers

    proxy.__contains__ = __contains__


apply()

"""``Spy``: a stand-in for the ``jax`` module inside one reference module,
recording what named ``jax`` functions were called with and returned.

    calls = []
    monkeypatch.setattr(repro.models.moe, "jax", Spy(jax, calls))

Then ``calls`` holds ``(name, args, result)`` for every ``lax.top_k`` and
``nn.one_hot`` that module made: how the port's tests read the reference's
MoE routing without editing it.  Under ``jit`` the recorded values are
tracers, so a caller that needs numbers returns them from the traced
function.
"""
import types

RECORDED = ("lax.top_k", "nn.one_hot")


class Spy:
    def __init__(self, mod, calls: list, path: str = ""):
        self._mod, self._calls, self._path = mod, calls, path

    def __getattr__(self, name):
        attr = getattr(self._mod, name)
        full = self._path + name
        if full in RECORDED:
            def record(*args, **kw):
                out = attr(*args, **kw)
                self._calls.append((full, args, out))
                return out
            return record
        if isinstance(attr, types.ModuleType):
            return Spy(attr, self._calls, full + ".")
        return attr
